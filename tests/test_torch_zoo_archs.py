"""The port's image zoo against the JAX package on the CPU: EDSR, MSRResNet
and RCAN at ×2/×3/×4, RIDNet, and DFDNet with its dictionary swap, at the
same weights and on the same numpy inputs.

Each port net is drawn from a seed (biases too, so they count), written in
the reference checkpoint's layout, and carried into flax by the JAX
package's own importers: `convert/torch_import.py` `import_network` for the
SR nets and RIDNet, `convert/dfdnet_import.py` `load_torch_dfdnet` for
DFDNet, whose wrapped convs go as spectral-norm triples made by
`dfdnet_reference_state_dict`. Flax templates come from `jax.eval_shape`
(no compiled init). Narrow widths (8–16 features, 1–2 blocks, 1 group);
DFDNet at 64 features and VGG19's full channels at 128², K = 4 atoms per
part. Float32 throughout; tolerance 1e-5 of max|ref|. A strict `.pth`
round trip through `convert.pth.load_pth` holds for every arch (RIDNet's
fixed `sub_mean`/`add_mean` included).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.dfdnet_import import (convert_dfdnet_dict,
                                                         load_torch_dfdnet)
from image_restoration_tpu.convert.torch_import import (convert_state_dict,
                                                        import_network)
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.archs.dfdnet_arch import (FEATURE_SIZES,
                                                           PARTS, part_box)
from image_restoration_tpu_torch.convert import (dfdnet_reference_state_dict,
                                                 dfdnet_state_dict,
                                                 load_dfdnet, load_dfdnet_dict)
from image_restoration_tpu_torch.convert.pth import load_pth

TOL = 1e-5
# the RIDNet rules of the reference golden (tests/test_video_archs.py)
RIDNET_RULES = [
    (r"^(sub_mean|add_mean)\..*", None),
    (r"^body\.(\d+)\.", lambda m: f"body_{m.group(1)}."),
    (r"merge\.dilation1\.0\.", "merge.d1_conv1."),
    (r"merge\.dilation1\.2\.", "merge.d1_conv2."),
    (r"merge\.dilation2\.0\.", "merge.d2_conv1."),
    (r"merge\.dilation2\.2\.", "merge.d2_conv2."),
    (r"merge\.aggregation\.0\.", "merge.agg."),
    (r"block2\.body\.0\.", "block2.conv1."),
    (r"block2\.body\.2\.", "block2.conv2."),
    (r"block2\.body\.4\.", "block2.conv3."),
    (r"ca\.attention\.1\.", "ca.fc1."),
    (r"ca\.attention\.3\.", "ca.fc2."),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _port_net(opt, seed):
    """The port net drawn from `seed`, every parameter then perturbed by
    5% of its tensor's std (biases by 0.02), so that zero biases count."""
    net = build_network(opt, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            scale = 0.02 if p.dim() == 1 else 0.05 * float(p.std())
            p.add_(scale * torch.randn(p.shape, generator=g))
    return net


def _sd(net):
    return {k: v.detach().numpy() for k, v in net.state_dict().items()}


def _flax(opt, net, *args):
    """The flax twin of `net` (template by eval_shape), its params through
    `import_network`."""
    jnet = jax_build(opt)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)
    return jnet, import_network(opt["type"], jnet, shapes, _sd(net))


SR_CASES = [
    dict(type="EDSR", num_feat=16, num_block=2, upscale=2, res_scale=0.1),
    dict(type="EDSR", num_feat=8, num_block=1, upscale=3),
    dict(type="EDSR", num_feat=16, num_block=2, upscale=4, res_scale=0.1),
    dict(type="MSRResNet", num_feat=16, num_block=2, upscale=2),
    dict(type="MSRResNet", num_feat=8, num_block=1, upscale=3),
    dict(type="MSRResNet", num_feat=16, num_block=2, upscale=4),
    dict(type="RCAN", num_feat=16, num_group=1, num_block=2,
         squeeze_factor=4, upscale=2),
    dict(type="RCAN", num_feat=16, num_group=2, num_block=1,
         squeeze_factor=4, upscale=4, res_scale=0.5),
    dict(type="RIDNet", mid_channels=16, num_block=1),
    dict(type="RIDNet", mid_channels=16, num_block=2,
         rgb_std=(0.9, 1.0, 1.1)),
]


def _case_id(opt):
    return "-".join(f"{v}" for k, v in opt.items() if k != "rgb_std")


def _input(opt, seed, hw=(12, 10)):
    x = np.random.default_rng(seed).random((2, *hw, 3)).astype(np.float32)
    return x * 255.0 if opt["type"] == "RIDNet" else x


@pytest.mark.parametrize("opt", SR_CASES, ids=_case_id)
def test_arch_matches_flax(opt):
    """Each arch against its flax twin at the same weights: 1e-5 of
    max|ref| in float32, on a non-square batch of 2."""
    net = _port_net(opt, 1400)
    x = _input(opt, 1401)
    jnet, variables = _flax(opt, net, jnp.asarray(x))
    want = np.asarray(jnet.apply({"params": variables["params"]},
                                 jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL, _rel(got, want)


def test_msrresnet_and_ridnet_through_the_golden_harness():
    """The two reference goldens of this slice (`test_archs.py::
    test_msrresnet_parity`, `test_video_archs.py::test_ridnet_parity`) with
    the port's modules in the reference modules' place: NCHW state_dicts
    through `convert_state_dict`, the goldens' shapes and rules."""
    rng = np.random.default_rng(1402)
    x = rng.random((1, 3, 24, 24)).astype(np.float32)
    xx = jnp.asarray(x.transpose(0, 2, 3, 1))
    for opt, rules, scale in (
            (dict(type="MSRResNet", num_in_ch=3, num_out_ch=3, num_feat=16,
                  num_block=2, upscale=4), (), 1.0),
            (dict(type="RIDNet", in_channels=3, mid_channels=16,
                  out_channels=3, num_block=1), RIDNET_RULES, 255.0)):
        net = _port_net(opt, 1403)
        with torch.no_grad():
            want = net(torch.from_numpy(x * scale).permute(0, 2, 3, 1))
        jnet = jax_build(opt)
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), xx)
        params = convert_state_dict(_sd(net), shapes["params"],
                                    key_rules=rules)
        got = np.asarray(jnet.apply({"params": params}, xx * scale))
        assert _rel(got, want.numpy()) <= TOL, opt["type"]


@pytest.mark.parametrize("opt", [SR_CASES[2], SR_CASES[5], SR_CASES[7],
                                 SR_CASES[9]], ids=_case_id)
def test_pth_round_trip_is_strict(opt, tmp_path):
    """A BasicSR-layout `.pth` ({"params": state_dict}) loads strictly into
    a fresh net, which then gives the same output bit for bit; RIDNet's
    MeanShift buffers are among the keys."""
    net = _port_net(opt, 1404)
    path = tmp_path / "net.pth"
    torch.save({"params": net.state_dict()}, path)
    fresh = build_network(opt, torch.Generator().manual_seed(9)).eval()
    fresh.load_state_dict(load_pth(str(path)), strict=True)
    x = torch.from_numpy(_input(opt, 1405))
    with torch.no_grad():
        assert torch.equal(net(x), fresh(x))
    if opt["type"] == "RIDNet":
        sd = fresh.state_dict()
        assert torch.equal(sd["sub_mean.bias"],
                           -255 * torch.tensor([0.4488, 0.4371, 0.4040])
                           / torch.tensor([0.9, 1.0, 1.1]))
        assert {"add_mean.weight", "add_mean.bias"} <= set(sd)
        assert not any(n.startswith(("sub_mean", "add_mean"))
                       for n, _ in fresh.named_parameters())


def test_rcan_init_finding():
    """JAX draws every RCAN conv with `conv_kaiming` (gain √2): each RCAB
    adds a residual about half the stream's variance, so the untrained
    output grows ≈1.5× a block (≈1e29 at the configs' 10×20; the L1 step
    of train_RCAN_x2.yml diverges on the card). The port draws RCAN's
    convs as the reference does (PyTorch's own init), and its untrained
    output stays at the input's scale. At 1 group of 12, 16 features."""
    opt = dict(type="RCAN", num_feat=16, num_group=1, num_block=12,
               squeeze_factor=4, upscale=2)
    x = np.random.default_rng(1409).random((1, 12, 12, 3)).astype(np.float32)
    jnet = jax_build(opt)
    jout = jnet.apply(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      jnp.asarray(x))
    net = build_network(opt, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert float(jnp.abs(jout).max()) > 100.0
    assert float(out.abs().max()) < 10.0
    w = net.body[0].residual_group[0].rcab[0].weight
    assert float(w.abs().max()) <= 1 / np.sqrt(16 * 9)
    assert float(net.conv_first.bias.abs().max()) > 0


# ------------------------------------------------------------------ DFDNet

DFD_SIZE = 128
# (x1, y1, x2, y2) at 128²: the nose box overlaps both eyes' and the mouth's
BOXES = np.array([[16, 32, 56, 64], [64, 32, 104, 64], [40, 48, 88, 96],
                  [32, 80, 96, 120]])
# atom (h, w) per tap; the mouth's are not square
ATOMS = {256: (16, 16), 128: (8, 8), 64: (4, 4), 32: (2, 3)}
CHANNELS = {256: 128, 128: 256, 64: 512, 32: 512}


def _dictionary(seed, k=4):
    """{'256': {part: (K, C, h, w)}} as the reference's pickle holds it."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in FEATURE_SIZES:
        h, w = ATOMS[f]
        out[str(f)] = {p: rng.standard_normal(
            (k, CHANNELS[f], h + (p == "mouth"), w + 2 * (p == "mouth"))
        ).astype(np.float32) for p in PARTS}
    return out


@pytest.fixture(scope="module")
def dfdnet_pair():
    """The port's DFDNet (64 features) with perturbed weights, its
    reference checkpoint (spectral-norm triples), the flax twin through
    `load_torch_dfdnet`, and a seeded dictionary and input."""
    opt = dict(type="DFDNet", num_feat=64)
    net = _port_net(opt, 1406)
    ref_sd = dfdnet_reference_state_dict(net, torch.Generator().manual_seed(7))
    x = (np.random.default_rng(1407).random((1, DFD_SIZE, DFD_SIZE, 3))
         .astype(np.float32) * 2 - 1)
    ref_dict = _dictionary(1408)
    jdict = {s: {p: jnp.asarray(v) for p, v in parts.items()}
             for s, parts in convert_dfdnet_dict(ref_dict).items()}
    jnet = jax_build(opt)
    shapes = jax.eval_shape(lambda k, xx: jnet.init(k, xx, BOXES, jdict),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    params = load_torch_dfdnet({k: v.numpy() for k, v in ref_sd.items()},
                               shapes["params"])
    # jitted at the fixed boxes: the same function as JAX's eager call, whose
    # first run compiles every op alone (≈7× slower)
    want = np.asarray(jax.jit(lambda p, xx, d: jnet.apply(
        {"params": p}, xx, BOXES, d))(params, jnp.asarray(x), jdict))
    return dict(net=net, ref_sd=ref_sd, x=x, ref_dict=ref_dict, want=want)


def _blank(net):
    """A copy of `net` with every parameter and buffer zeroed: a load must
    fill them all."""
    fresh = copy.deepcopy(net)
    with torch.no_grad():
        for t in fresh.state_dict().values():
            t.zero_()
    return fresh


def _port_dfdnet(net, pair, boxes):
    tdict = load_dfdnet_dict(pair["ref_dict"], device="cpu")
    with torch.no_grad():
        return net(torch.from_numpy(pair["x"]), boxes, tdict).numpy()


def test_dfdnet_matches_flax(dfdnet_pair):
    """The port's DFDNet, loaded from the reference checkpoint by
    `dfdnet_state_dict` (spectral norm folded, VGG names mapped, mean/std
    dropped), against flax through `load_torch_dfdnet`: 1e-5 of max|ref|
    at 128², boxes overlapping, K = 4."""
    pair = dfdnet_pair
    fresh = _blank(pair["net"])
    fresh.load_state_dict(dfdnet_state_dict(pair["ref_sd"]), strict=True)
    want = pair["want"]
    got = _port_dfdnet(fresh, pair, BOXES)
    assert got.shape == want.shape == (1, DFD_SIZE, DFD_SIZE, 3)
    assert _rel(got, want) <= TOL, _rel(got, want)
    # the fold gives the port's own weights back
    with torch.no_grad():
        for (k, a), b in zip(pair["net"].state_dict().items(),
                             fresh.state_dict().values()):
            assert float((a - b).abs().max()) <= 1e-6 * float(
                a.abs().max()), k


def test_dfdnet_reads_the_unmodified_feature(dfdnet_pair):
    """Overlapping boxes: every part reads the VGG feature as the encoder
    made it, not an earlier part's write. Reversing the parts' order
    changes nothing where no two boxes overlap at a tap, and a swap written
    in order (each part reading the running update) departs from both
    JAX and the port."""
    pair, net = dfdnet_pair, dfdnet_pair["net"]
    boxes = BOXES.copy()
    x = torch.from_numpy(pair["x"])
    tdict = load_dfdnet_dict(pair["ref_dict"], device="cpu")
    with torch.no_grad():
        feats = net.vgg_extractor(x)
        f_size, layer = 128, "relu3_4"
        vgg_feat = feats[layer]
        updated = vgg_feat.clone()
        chained = vgg_feat.clone()
        for i, part in enumerate(PARTS):
            box = part_box(boxes[i], f_size)
            net.swap(vgg_feat, updated, tdict[str(f_size)][part], box, part,
                     f_size)
            net.swap(chained.clone(), chained, tdict[str(f_size)][part],
                     box, part, f_size)
    nose = part_box(boxes[2], f_size)
    eye = part_box(boxes[0], f_size)
    # the nose box overlaps the left eye's at this tap
    assert nose[0] < eye[2] and nose[1] < eye[3]
    assert not torch.allclose(updated, chained)
    got = _port_dfdnet(net, pair, BOXES)
    assert _rel(got, pair["want"]) <= TOL


def test_dfdnet_pth_and_dictionary_files(dfdnet_pair, tmp_path):
    """`load_dfdnet` reads a BasicSR-layout DFDNet `.pth` (bare state_dict,
    spectral-norm triples) strictly, `load_dfdnet_dict` the dictionary
    `.pth`; DFDNet refuses a batch of 2."""
    pair = dfdnet_pair
    torch.save(pair["ref_sd"], tmp_path / "DFDNet.pth")
    torch.save({s: {p: torch.from_numpy(v) for p, v in parts.items()}
                for s, parts in pair["ref_dict"].items()},
               tmp_path / "dict.pth")
    net = load_dfdnet(str(tmp_path / "DFDNet.pth"), _blank(pair["net"]))
    tdict = load_dfdnet_dict(str(tmp_path / "dict.pth"), device="cpu")
    assert tuple(tdict["32"]["mouth"].shape) == (4, 3, 5, 512)
    x = torch.from_numpy(pair["x"])
    with torch.no_grad():
        got = net(x, BOXES, tdict).numpy()
    assert _rel(got, pair["want"]) <= TOL
    with pytest.raises(ValueError, match="batch 1"):
        net(x.expand(2, -1, -1, -1), BOXES, tdict)
