"""The port's video archs against the JAX package on the CPU: SpyNet, EDVR
(TSA; without TSA; `hr_in` with the pre-deblur head), BasicVSR, IconVSR,
DUF (16 layers, with and without `adapt_official_weights`, with running
BatchNorm statistics) and TOFlow (with and without the official frame
order), at the same weights and on the same numpy inputs.

Each port net is drawn from a seed, its parameters then perturbed (and
BatchNorm statistics drawn), written in the reference checkpoint's
layout and carried into flax by the JAX package's own importer,
`convert/torch_import.py` `import_network` (standalone SpyNet through
`convert_state_dict` with the rules of its golden, `tests/
test_video_archs.py:133`). Flax templates come from `jax.eval_shape`.
Narrow widths (8–16 features, 1 block, 3–7 frames); the SpyNet-based
nets at 36×40 LQ, which SpyNet resizes to 64² (its 6-level pyramid needs
more than 32 px, under JAX as here). Float32; tolerance 1e-5 of max|ref|.
Every arch's `state_dict` loads back strictly through `convert.pth`, and
`spynet_path` / `edvr_path` load a reference `.pth` into their submodule
(a missing one raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.torch_import import (convert_state_dict,
                                                        import_network)
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert.pth import load_pth

TOL = 1e-5
SPYNET_RULES = [(r"basic_module\.(\d+)\.basic_module\.(\d+)",
                 lambda m: f"basic_module_{m.group(1)}."
                           f"conv{int(m.group(2)) // 2}"),
                (r"^(mean|std)$", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _port_net(opt, seed):
    """The port net drawn from `seed`, every parameter perturbed by 5% of
    its tensor's std (biases by 0.02) so zero biases count, and BatchNorm
    statistics drawn (means ±0.1, variances 1–1.2)."""
    net = build_network(opt, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            scale = 0.02 if p.dim() == 1 else 0.05 * float(p.std())
            p.add_(scale * torch.randn(p.shape, generator=g))
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(1 + 0.2 * torch.rand(b.shape, generator=g))
    return net


def _sd(net):
    return {k: v.detach().numpy() for k, v in net.state_dict().items()}


CASES = {  # id: (options, input shape, inputs, jit the flax side)
    "spynet": (dict(type="SpyNet"), (2, 36, 40, 3), 2, True),
    "edvr-tsa": (dict(type="EDVR", num_feat=16, num_frame=3,
                      deformable_groups=2, num_extract_block=1,
                      num_reconstruct_block=1), (1, 3, 16, 16, 3), 1, True),
    "edvr-woTSA": (dict(type="EDVR", num_feat=16, num_frame=3,
                        deformable_groups=4, num_extract_block=1,
                        num_reconstruct_block=1, with_tsa=False,
                        center_frame_idx=0), (1, 3, 16, 16, 3), 1, True),
    "edvr-hr_in-predeblur": (dict(type="EDVR", num_feat=8, num_frame=3,
                                  deformable_groups=2, num_extract_block=1,
                                  num_reconstruct_block=1, hr_in=True,
                                  with_predeblur=True), (1, 3, 64, 64, 3), 1,
                             True),
    "basicvsr": (dict(type="BasicVSR", num_feat=8, num_block=1),
                 (1, 3, 36, 40, 3), 1, True),
    "iconvsr": (dict(type="IconVSR", num_feat=16, num_block=1,
                     temporal_padding=1), (1, 3, 36, 40, 3), 1, True),
    "duf-official": (dict(type="DUF", num_layer=16,
                          adapt_official_weights=True), (1, 7, 8, 8, 3), 1,
                     True),
    "duf": (dict(type="DUF", num_layer=16), (1, 7, 8, 8, 3), 1, True),
    "toflow": (dict(type="TOFlow"), (1, 7, 16, 16, 3), 1, True),
    "toflow-official": (dict(type="TOFlow", adapt_official_weights=True),
                        (1, 7, 16, 16, 3), 1, True),
}


def _flax_variables(opt, net, args):
    jnet = jax_build(opt)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)
    if opt["type"] == "SpyNet":  # import_network knows it only as a part
        return jnet, {"params": convert_state_dict(
            _sd(net), shapes["params"], key_rules=SPYNET_RULES)}
    return jnet, import_network(opt["type"], jnet, shapes, _sd(net))


@pytest.mark.parametrize("case", list(CASES))
def test_arch_matches_flax(case):
    """The arch against its flax twin at imported weights: 1e-5 of max|ref|
    in float32."""
    opt, shape, n_in, jit = CASES[case]
    net = _port_net(opt, 1700)
    rng = np.random.default_rng(1701)
    xs = [rng.random(shape).astype(np.float32) for _ in range(n_in)]
    jxs = [jnp.asarray(x) for x in xs]
    jnet, variables = _flax_variables(opt, net, jxs)
    apply = jax.jit(jnet.apply) if jit else jnet.apply
    want = np.asarray(apply(variables, *jxs))
    with torch.no_grad():
        got = net(*[torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL, _rel(got, want)


def test_state_dicts_load_strictly(tmp_path):
    """Every arch's reference-layout state_dict (DUF's and TOFlow's
    BatchNorm buffers, SpyNet's and TOFlow's mean/std included) loads
    strictly into a net drawn from another seed through `load_pth`."""
    for opt, _, _, _ in CASES.values():
        net = _port_net(opt, 1710)
        path = str(tmp_path / "net.pth")
        torch.save({"params": net.state_dict()}, path)
        other = build_network(opt, torch.Generator().manual_seed(1711))
        other.load_state_dict(load_pth(path), strict=True)
        for (k, a), b in zip(net.state_dict().items(),
                             other.state_dict().values()):
            assert torch.equal(a, b), (opt["type"], k)


def test_spynet_and_edvr_paths_load_after_the_draw(tmp_path):
    """`spynet_path` and `edvr_path` name reference `.pth` files that
    `build_network` loads into the submodule after drawing the rest; a
    path that is given but missing raises."""
    spy = _port_net(dict(type="SpyNet"), 1720)
    edvr = _port_net(dict(type="EDVRFeatureExtractor", num_input_frame=3,
                          num_feat=16), 1721)
    torch.save({"params": spy.state_dict()}, tmp_path / "spy.pth")
    torch.save({"params": edvr.state_dict()}, tmp_path / "edvr.pth")
    net = build_network(dict(type="IconVSR", num_feat=16, num_block=1,
                             temporal_padding=1,
                             spynet_path=str(tmp_path / "spy.pth"),
                             edvr_path=str(tmp_path / "edvr.pth")),
                        torch.Generator().manual_seed(1722))
    for sub, ref in ((net.spynet, spy), (net.edvr, edvr)):
        for a, b in zip(sub.state_dict().values(),
                        ref.state_dict().values()):
            assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        build_network(dict(type="BasicVSR", num_feat=8, num_block=1,
                           spynet_path=str(tmp_path / "missing.pth")))
