"""The port's char-component discriminators against the JAX package.

`roi_align` against JAX's (forward ≤1e-6 abs, gradient ≤1e-5 of
max|grad|: at 64² crops of a 20×30 image a pixel sums hundreds of
samples, |grad| reaches ~40), with boxes
that cross the edge, are narrower than a pixel or lie outside [−1, H]; the
ten char Ds as one grouped `FacialComponentDiscriminator(groups=10)`
against JAX's `jax.vmap`ped one at 16² crops (logits and both features
≤1e-5 of max|ref|), also under `IRT_FUSE_DOWN`; the G-side per-char GAN
and Gram style losses with their gradient to the G output, and the D-side
per-char losses with the ten Ds' gradients, against `jax.value_and_grad` of
JAX's terms (`models/gfpgan_model.py:285-312`, `:363-387`) at flax weights
carried by `stacked_state_dict_from_jax` (losses ≤1e-5 relative, gradients
≤1e-4 of max|grad|, with the rule of tests/test_torch_gfpgan_train.py for
a pre-activation at the LeakyReLU kink: 1e-4 of the D parameters' elements,
1% of the image gradient's, may reach 1e-3); `crop_components` from an
`.npz` and from a `.pth` dict, the `KeyError` without boxes, and `train_pipeline` with the
component Ds (and the identity loss) on the CPU: every char D moves, the
IResNet does not, a resume restores the Ds; each of the four component and
identity configs builds and trains at tiny overrides.
"""

import os
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs.gfpganv1_arch import \
    FacialComponentDiscriminator as JaxCharD
from image_restoration_tpu.losses import build_loss as jax_build_loss
from image_restoration_tpu.models.gfpgan_model import _gram as jax_gram
from image_restoration_tpu.ops import fused_resample as jax_fused_resample
from image_restoration_tpu.ops.roi_align import roi_align as jax_roi_align
from image_restoration_tpu_torch.archs import build_network, stylegan2_arch
from image_restoration_tpu_torch.convert import stacked_state_dict_from_jax
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.models.gfpgan_model import NUM_CHARS
from image_restoration_tpu_torch.ops import fused_resample
from image_restoration_tpu_torch.ops.roi_align import roi_align
from image_restoration_tpu_torch.train import train_pipeline

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TINY_G = dict(type="GFPGANv1OCR", input_width=32, input_height=32,
              num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
              input_is_latent=True, different_w=True, narrow=0.5,
              sft_half=True, fix_decoder=False)
TINY_D = dict(type="StyleGAN2Discriminator", input_width=32,
              input_height=32, channel_multiplier=0.25, narrow=0.25)
GAN_COMPONENT = {"type": "GANLoss", "gan_type": "vanilla",
                 "real_label_val": 1.0, "fake_label_val": 0.0,
                 "loss_weight": 1.0}
GAN = {"type": "GANLoss", "gan_type": "wgan_softplus", "loss_weight": 0.1}
L1 = {"type": "L1Loss", "loss_weight": 1.0}
COMP_STYLE_WEIGHT = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, size):
    """(n, 10, 4) char boxes in a size² image, 4-12 px on a side."""
    x1 = rng.uniform(0, size - 12, (n, NUM_CHARS))
    y1 = rng.uniform(0, size - 12, (n, NUM_CHARS))
    wh = rng.uniform(4, 12, (n, NUM_CHARS, 2))
    return np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]],
                    -1).astype(np.float32)


# ------------------------------------------------------------- roi_align

@pytest.mark.parametrize("out_size", [7, 64])
def test_roi_align_matches_jax(out_size):
    rng = np.random.default_rng(out_size)
    img = rng.uniform(-1, 1, (2, 20, 30, 3)).astype(np.float32)
    lo = np.stack([rng.uniform(-4, 31, (2, 8)), rng.uniform(-4, 21, (2, 8))],
                  -1)
    boxes = np.concatenate([lo, lo + rng.uniform(2, 12, (2, 8, 2))],
                           -1).astype(np.float32)
    boxes[0, 0] = [25, 15, 40, 30]      # crosses the right and bottom edge
    boxes[0, 1] = [-8, -8, -3, -2]      # outside [-1, H] on both axes
    boxes[1, 0] = [3, 3, 3.4, 3.2]      # narrower than a pixel
    boxes[1, 1] = [-2, 5, 8, 25]        # crosses the left and bottom edge
    want = np.asarray(jax_roi_align(jnp.asarray(img), jnp.asarray(boxes),
                                    out_size))
    got = roi_align(torch.from_numpy(img), torch.from_numpy(boxes),
                    out_size)
    assert got.shape == (2, 8, out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.all(want[0, 1] == 0)

    g = rng.standard_normal(want.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jax_roi_align(
        x, jnp.asarray(boxes), out_size) * g))(jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_(True)
    (roi_align(x, torch.from_numpy(boxes), out_size)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


# -------------------------------------------------------- the char Ds

def _jax_char_params(size, seed):
    """JAX's ten stacked char-D trees (its model's init, vmapped), plus
    noise so the zero-initialized biases count."""
    d = JaxCharD()
    ex = jnp.zeros((1, size, size, 3), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), NUM_CHARS)
    params = jax.device_get(jax.jit(jax.vmap(
        lambda k: d.init(k, ex)["params"]))(keys))
    rng = np.random.default_rng(seed)
    return d, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)


def _jax_dc_apply(d, params, crops):
    return jax.vmap(lambda p, x: d.apply({"params": p}, x,
                                         return_feats=True))(params, crops)


@pytest.mark.parametrize("fuse_down", [False, True])
def test_stacked_char_ds_match_jax_vmap(monkeypatch, fuse_down):
    """FacialComponentDiscriminator(groups=10) on (10, B, 16, 16, 3) crops
    against JAX's vmap over the stacked tree; under FUSE_DOWN both take
    the fused downsample (the port's with groups)."""
    monkeypatch.setattr(jax_fused_resample, "FUSE_DOWN", fuse_down)
    monkeypatch.setattr(fused_resample, "FUSE_DOWN", fuse_down)
    d, params = _jax_char_params(16, 0)
    crops = np.random.default_rng(1).uniform(
        -1, 1, (NUM_CHARS, 2, 16, 16, 3)).astype(np.float32)
    jl, jf = jax.jit(lambda p, x: _jax_dc_apply(d, p, x))(
        params, jnp.asarray(crops))
    net = build_network(dict(type="FacialComponentDiscriminator",
                             groups=NUM_CHARS))
    net.load_state_dict(stacked_state_dict_from_jax(net, params))
    with torch.no_grad(), mock.patch.object(
            stylegan2_arch, "conv_down_fir",
            wraps=fused_resample.conv_down_fir) as spy:
        logits, feats = net.forward_stacked(torch.from_numpy(crops),
                                            return_feats=True)
    assert spy.call_count == (2 if fuse_down else 0)
    assert logits.shape == (NUM_CHARS, 2, 4, 4, 1)
    for got, want in zip([logits] + feats, [jl] + list(jf)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_char_d_layout_and_per_char_pretrain(tmp_path):
    """groups=1 is the reference's single D (its keys); D number i of the
    stack reads and writes that layout, and a `pretrain_network_d_char_i`
    `.pth` loads into group i only."""
    one = build_network(dict(type="FacialComponentDiscriminator"),
                        torch.Generator().manual_seed(3))
    assert sorted(one.state_dict()) == sorted(
        [f"conv{i}.0.weight" for i in (1, 3, 5)]
        + [f"conv{i}.1.bias" for i in (1, 3, 5)]
        + [f"conv{i}.1.weight" for i in (2, 4)]
        + [f"conv{i}.2.bias" for i in (2, 4)]
        + ["final_conv.0.weight", "final_conv.0.bias"])
    pth = tmp_path / "d_char_3.pth"
    torch.save({"params": one.state_dict()}, pth)
    opt = _model_opt(tmp_path)
    opt["path"]["pretrain_network_d_char_3"] = str(pth)
    fresh = build_model(_model_opt(tmp_path), device="cpu")
    model = build_model(opt, device="cpu")
    for i in range(NUM_CHARS):
        got = model.net_d_char.char_state_dict(i)
        want = (one.state_dict() if i == 3
                else fresh.net_d_char.char_state_dict(i))
        for k, v in want.items():
            assert torch.equal(got[k], v), (i, k)
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(4))
    crops = x[None].expand(NUM_CHARS, -1, -1, -1, -1)
    with torch.no_grad():
        stacked = model.net_d_char.forward_stacked(crops)[0][3]
        single = one(x)[0]
    torch.testing.assert_close(stacked, single, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ component loss terms

def _model_opt(tmp, **train):
    t = {"optim_g": {"type": "Adam", "lr": 2e-3},
         "optim_d": {"type": "Adam", "lr": 2e-3},
         "optim_component": {"type": "Adam", "lr": 2e-3},
         "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
         "L1_opt": dict(L1), "gan_opt": dict(GAN),
         "gan_component_opt": dict(GAN_COMPONENT),
         "comp_style_weight": COMP_STYLE_WEIGHT,
         "r1_reg_weight": 10, "net_d_reg_every": 2}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "model_type": "GFPGANModel", "use_component_loss": True,
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis")},
            "network_g": dict(TINY_G), "network_d": dict(TINY_D),
            "network_d_char": {"type": "FacialComponentDiscriminator"},
            "train": t}


@pytest.fixture(scope="module")
def comp(tmp_path_factory):
    """A tiny port model whose char Ds hold JAX's (64² init) weights, and
    an output/GT pair with boxes."""
    tmp = tmp_path_factory.mktemp("comp")
    model = build_model(_model_opt(tmp), device="cpu")
    d, params = _jax_char_params(64, 5)
    model.net_d_char.load_state_dict(
        stacked_state_dict_from_jax(model.net_d_char, params))
    rng = np.random.default_rng(6)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    out = np.clip(gt + rng.normal(0, 0.3, gt.shape), -1, 1).astype(
        np.float32)
    return dict(model=model, d=d, params=params, gt=gt, out=out,
                boxes=_boxes(rng, 2, 32))


def _jax_crops(img, boxes):
    return jnp.swapaxes(jax_roi_align(img, boxes, 64), 0, 1)


def _check_losses(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= LOSS_RTOL * np.abs(want)), (got, want)


def _check_image_grad(got, want):
    """≤1e-4 of max|grad|, except where a LeakyReLU kink flips: a char D
    pre-activation within float32 rounding of 0 takes the other slope in
    one of the two (both stand equally far from a float64 run), and the
    gradient to the image carries that to every pixel the unit sees, so
    up to 1% of the pixels may reach 1e-3 of max|grad| (the parameter
    gradients' rule, 1e-4 of elements, is for sums over a whole batch)."""
    scale = float(np.abs(want).max())
    assert scale > 0
    d = np.abs(got - want)
    assert d.max() <= 10 * GRAD_TOL * scale, d.max() / scale
    assert (d > GRAD_TOL * scale).mean() <= 0.01


def test_component_g_losses_and_grad_match_jax(comp):
    """The per-char vanilla GAN losses of the fake crops and the Gram style
    loss (0.5·L1(gram₀) + L1(gram₁) against the GT crops' features, times
    comp_style_weight), and their gradient to the G output."""
    d, params, boxes = comp["d"], comp["params"], jnp.asarray(comp["boxes"])
    cri_comp, cri_l1 = jax_build_loss(GAN_COMPONENT), jax_build_loss(L1)
    gt = jnp.asarray(comp["gt"])

    def g_terms(output):        # JAX gfpgan_model.py:285-312
        logits, fake = _jax_dc_apply(d, params, _jax_crops(output, boxes))
        l_char = jax.vmap(lambda lg: cri_comp(lg, True, is_disc=False))(
            logits)
        _, real = _jax_dc_apply(d, params,
                                _jax_crops(jax.lax.stop_gradient(gt), boxes))

        def style_one(f0, f1, r0, r1):
            return (cri_l1(jax_gram(f0), jax.lax.stop_gradient(jax_gram(r0)))
                    * 0.5 + cri_l1(jax_gram(f1),
                                   jax.lax.stop_gradient(jax_gram(r1))))

        l_cs = jax.vmap(style_one)(fake[0], fake[1], real[0], real[1]).sum() \
            * COMP_STYLE_WEIGHT
        return l_char.sum() + l_cs, (l_char, l_cs)

    (_, (jl_char, jl_cs)), jgrad = jax.jit(jax.value_and_grad(
        g_terms, has_aux=True))(jnp.asarray(comp["out"]))
    model = comp["model"]
    model.net_d_char.requires_grad_(False)
    out = torch.from_numpy(comp["out"]).requires_grad_(True)
    l_char, l_cs = model.component_g_losses(
        out, torch.from_numpy(comp["gt"]), torch.from_numpy(comp["boxes"]))
    (l_char.sum() + l_cs).backward()
    model.net_d_char.requires_grad_(True)
    assert all(p.grad is None for p in model.net_d_char.parameters())
    _check_losses(l_char.detach().numpy(), jl_char)
    _check_losses(float(l_cs.detach()), jl_cs)
    _check_image_grad(out.grad.numpy(), np.asarray(jgrad))


def test_component_d_losses_and_grads_match_jax(comp):
    """Per-char D losses (vanilla on the real crop + gan_opt's wgan_softplus
    on the fake, JAX's mix) and the ten Ds' gradients."""
    d, params, boxes = comp["d"], comp["params"], jnp.asarray(comp["boxes"])
    cri_comp, cri_gan = jax_build_loss(GAN_COMPONENT), jax_build_loss(GAN)
    cf = _jax_crops(jnp.asarray(comp["out"]), boxes)
    cr = _jax_crops(jnp.asarray(comp["gt"]), boxes)

    def dc_loss(p):             # JAX gfpgan_model.py:363-387
        fl, _ = _jax_dc_apply(d, p, cf)
        rl, _ = _jax_dc_apply(d, p, cr)
        per = jax.vmap(lambda r, f: cri_comp(r, True, is_disc=True)
                       + cri_gan(f, False, is_disc=True))(rl, fl)
        return per.sum(), per

    (_, jper), jgrads = jax.jit(jax.value_and_grad(dc_loss, has_aux=True))(
        params)
    net = comp["model"].net_d_char
    net.zero_grad(set_to_none=True)
    per = comp["model"].component_d_losses(
        torch.from_numpy(comp["out"]), torch.from_numpy(comp["gt"]),
        torch.from_numpy(comp["boxes"]))
    per.sum().backward()
    _check_losses(per.detach().numpy(), jper)
    want = stacked_state_dict_from_jax(
        net, jax.tree_util.tree_map(np.asarray, jgrads))
    scale = max(float(v.abs().max()) for v in want.values())
    over = total = 0
    for name, p in net.named_parameters():
        d = (p.grad - want[name]).abs()
        assert float(d.max()) <= 10 * GRAD_TOL * scale, name
        over += int((d > GRAD_TOL * scale).sum())
        total += d.numel()
    assert over <= total * 1e-4, (over, total)
    net.zero_grad(set_to_none=True)


def test_step_without_boxes_raises_key_error(comp):
    batch = {"gt": comp["gt"], "lq": comp["gt"] * 0.5}
    with pytest.raises(KeyError, match="char_boxes"):
        comp["model"].optimize_parameters(1, batch)


# -------------------------------------------------------------- dataset

def _write_images(folder, n, h, w, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"img_{i}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_crop_components_from_npz_and_pth(tmp_path, fmt):
    """Each item carries its image's (10, 4) float32 boxes, from an .npz
    `boxes` array or the reference's '%08d'-keyed .pth dict of char_i
    vectors (extra entries after the fourth ignored); the loader stacks
    them."""
    from image_restoration_tpu_torch.data import build_dataloader
    _write_images(tmp_path / "gt", 3, 20, 40, 0)
    boxes = _boxes(np.random.default_rng(1), 3, 32)
    if fmt == "npz":
        path = tmp_path / "boxes.npz"
        np.savez(path, boxes=boxes)
    else:
        path = tmp_path / "boxes.pth"
        torch.save({f"{i:08d}": {f"char_{c}": torch.tensor(
            list(boxes[i, c]) + [0.9]) for c in range(NUM_CHARS)}
            for i in range(3)}, path)
    opt = {"type": "FFHQDegradationDataset", "name": "t", "phase": "train",
           "dataroot_gt": str(tmp_path / "gt"), "input_width": 32,
           "input_height": 32, "crop_components": True,
           "component_path": str(path), "batch_size_per_gpu": 3,
           "num_worker_per_gpu": 1, "use_shuffle": False}
    ds = build_dataset(opt)
    for i in range(3):
        item = ds[i]
        assert item["char_boxes"].dtype == np.float32
        np.testing.assert_array_equal(item["char_boxes"], boxes[i])
    batch = next(iter(build_dataloader(ds, opt)))
    assert batch["char_boxes"].shape == (3, NUM_CHARS, 4)
    with pytest.raises(ValueError, match="use_hflip"):
        build_dataset(dict(opt, use_hflip=True))


# ------------------------------------------------------ train_pipeline

TINY_CONFIG = """
name: tiny_component
model_type: GFPGANModel
manual_seed: 0
num_devices: 1
use_component_loss: true

datasets:
  train:
    name: tiny
    type: FFHQDegradationDataset
    dataroot_gt: {root}/gt
    io_backend: {{type: disk}}
    use_hflip: false
    input_width: 32
    input_height: 32
    kernel_list: ['iso', 'aniso']
    kernel_prob: [0.5, 0.5]
    blur_sigma: [0.1, 10]
    downsample_range: [2.0, 4.0]
    noise_range: [0, 20]
    jpeg_range: [30, 100]
    crop_components: true
    component_path: {root}/boxes.npz
    batch_size_per_gpu: 2
    num_worker_per_gpu: 1
    dataset_enlarge_ratio: 1

network_g: {g}
network_d: {d}
network_d_char: {{type: FacialComponentDiscriminator}}
network_identity: {{type: IResNet18, num_features: 32}}

path:
  pretrain_network_identity: ~

train:
  optim_g: {{type: Adam, lr: !!float 2e-3}}
  optim_d: {{type: Adam, lr: !!float 2e-3}}
  optim_component: {{type: Adam, lr: !!float 2e-3}}
  total_iter: 2
  pixel_opt: {{type: L1Loss, loss_weight: 0.1}}
  L1_opt: {{type: L1Loss, loss_weight: 1}}
  gan_opt: {{type: GANLoss, gan_type: wgan_softplus, loss_weight: 0.1}}
  gan_component_opt: {{type: GANLoss, gan_type: vanilla, loss_weight: 1}}
  comp_style_weight: 200
  identity_weight: 10
  r1_reg_weight: 10
  net_d_reg_every: 2

logger:
  print_freq: 1
  save_checkpoint_freq: 2
"""


def _flow(d):
    return "{" + ", ".join(f"{k}: {v}" for k, v in d.items()) + "}"


def test_train_pipeline_components_identity_and_resume(tmp_path):
    """2 iterations (R1 at 2) with the char Ds and the identity loss: every
    char D moved and its Adam stepped twice, the IResNet is bit-unchanged
    and out of the optimizers and the checkpoint; a resume from ckpt_2
    restores the char Ds and their Adam bit-equal."""
    _write_images(tmp_path / "gt", 4, 40, 40, 2)
    np.savez(tmp_path / "boxes.npz",
             boxes=_boxes(np.random.default_rng(3), 4, 32))
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_CONFIG.format(root=tmp_path, g=_flow(TINY_G),
                                      d=_flow(TINY_D)))
    argv = ["-opt", str(cfg)]
    model = train_pipeline(str(tmp_path), argv=argv, device="cpu")
    fresh = build_model(model.opt, device="cpu")
    logs = model.log_dict
    assert model.iter == 2 and model.optimizer_dc.count == 2
    assert all(np.isfinite(v) for v in logs.values())
    assert {f"l_d_char_{i}" for i in range(NUM_CHARS)} <= set(logs)
    assert {f"l_g_gan_char_{i}" for i in range(NUM_CHARS)} <= set(logs)
    assert {"l_g_comp_style_loss", "l_identity", "l_d_r1"} <= set(logs)
    for i in range(NUM_CHARS):
        a = model.net_d_char.char_state_dict(i)
        b = fresh.net_d_char.char_state_dict(i)
        assert all(not torch.equal(a[k], b[k]) for k in a), i
    for k, v in model.net_identity.state_dict().items():
        assert torch.equal(v, fresh.net_identity.state_dict()[k]), k
    assert not any(p.requires_grad for p in model.net_identity.parameters())
    ids = {id(p) for p in model.net_identity.parameters()}
    assert not any(id(p) in ids for tx in model.optimizers
                   for p in tx.params)
    exp = tmp_path / "experiments" / "tiny_component" / "models"
    state = torch.load(exp / "ckpt_2.pth", weights_only=True)
    assert not any("identity" in k for k in state)

    resumed = build_model(model.opt, device="cpu")
    resumed.resume(str(exp / "ckpt_2.pth"))
    for k, v in resumed.net_d_char.state_dict().items():
        assert torch.equal(v, model.net_d_char.state_dict()[k]), k
    sa = resumed.optimizer_dc.opt.state_dict()["state"]
    sb = model.optimizer_dc.opt.state_dict()["state"]
    assert sa.keys() == sb.keys() and resumed.optimizer_dc.count == 2
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("config, hw", [
    ("train_gfpgan_plate_256x64_component.yml", (16, 64)),
    ("train_gfpgan_plate_256sq_component.yml", (32, 32)),
    ("train_gfpgan_plate_256sq_component_long.yml", (32, 32)),
    ("train_gfpgan_plate_256_identity.yml", (32, 32))])
def test_configs_train_at_tiny_overrides(tmp_path, config, hw):
    """The config as written, cut with --force_yml to tiny widths (G and D
    at hw, num_style_feat 16, two MLP layers, narrow nets), batch 1 and
    one iteration: it builds and trains through `train_pipeline`."""
    h, w = hw
    _write_images(tmp_path / "gt", 2, 40, 80, 4)
    np.savez(tmp_path / "boxes.npz",
             boxes=_boxes(np.random.default_rng(5), 2, min(h, w)))
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    argv = ["-opt", os.path.join(root, "configs", config), "--force_yml",
            "train:total_iter=1", "logger:use_tb_logger=false",
            "datasets:train:batch_size_per_gpu=1"]
    for phase in ("train", "val"):
        argv += [f"datasets:{phase}:dataroot_gt={tmp_path}/gt",
                 f"datasets:{phase}:input_width={w}",
                 f"datasets:{phase}:input_height={h}",
                 f"datasets:{phase}:component_path={tmp_path}/boxes.npz"]
    for net, widths in (("network_g", dict(
            num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
            narrow=0.5)), ("network_d", dict(channel_multiplier=0.25,
                                              narrow=0.25))):
        argv += [f"{net}:{k}={v}" for k, v in dict(
            widths, input_width=w, input_height=h).items()]
    model = train_pipeline(str(tmp_path), argv=argv, device="cpu")
    assert model.iter == 1
    assert all(np.isfinite(v) for v in model.log_dict.values())
    assert ("l_identity" in model.log_dict) == ("identity" in config)
    assert ("l_d_char_9" in model.log_dict) == ("component" in config)
