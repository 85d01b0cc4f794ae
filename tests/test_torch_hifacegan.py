"""The port's HiFaceGAN against the JAX package on the CPU: the `nearest`
resize mode, SPADE, the LIP encoder, both generators and the multi-scale
discriminator, `fold_spectral_norm` and a BasicSR-layout checkpoint, one
`HiFaceGANModel` G+D step and its loss gradients, the two JAX findings
(the feature-matching option's name, and D seeing the image alone), and
the shipped configs through `train_pipeline` and `test_pipeline`.

num_feat 8 at 64² throughout. Weights are drawn in numpy in flax's
layout (or flax's init, perturbed, in the models), so zero biases count,
and carried by `hifacegan_state_dict_from_jax`. Tolerances: `nearest`
and `fold_spectral_norm` exact; SPADE and the discriminator within 1e-5
of max|ref| in float32; the LIP encoder and the generators, whose
instance norms down to 2² amplify float32 rounding (port and JAX each lie
1–4e-5 of max|ref| from a float64 forward), within 1e-4 in float32 and
1e-10 in float64 (JAX under x64), where both compute the same function;
losses ≤1e-5 relative; gradients ≤1e-5 of max|grad|; parameters after an
SGD step ≤1e-5 of max|p|.
"""

import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.hifacegan_import import \
    fold_spectral_norm as jax_fold
from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu.ops import resize as jresize
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.archs import hifacegan_arch as tha
from image_restoration_tpu_torch.convert import (fold_spectral_norm,
                                                 hifacegan_state_dict_from_jax,
                                                 load_hifacegan,
                                                 vgg_state_dict_from_jax)
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.ops import resize as tresize
from image_restoration_tpu_torch.test import \
    test_pipeline as port_test_pipeline
from image_restoration_tpu_torch.train import train_pipeline
from test_torch_sr_train import _check_losses, _check_params, _perturb

TRAIN_YML = "configs/options/train/HiFaceGAN/train_hifacegan.yml"
TEST_YML = "configs/options/test/HiFaceGAN/test_hifacegan.yml"
TEST_WOGT_YML = "configs/options/test/HiFaceGAN/test_hifacegan_woGT.yml"
G = dict(type="HiFaceGAN", num_feat=8, is_train=False)
D = dict(type="HiFaceGANDiscriminator", num_feat=8, num_d=2, n_layers_d=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32) \
        * 2 - 1


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------- nearest


@pytest.mark.parametrize("hw,out", [((64, 48), (2, 3)), ((5, 7), (16, 21)),
                                    ((64, 64), (8, 8)), ((30, 20), (7, 13))])
def test_nearest_bit_equal_to_jax(hw, out):
    """`cv2_resize_matrix(..., "nearest")` equal to JAX's, and `resize`
    (a gather) bit-equal to JAX's one-hot matmul, downsampling and
    upsampling, at integer and other ratios."""
    for i, o in zip(hw, out):
        np.testing.assert_array_equal(
            tresize.cv2_resize_matrix(i, o, "nearest"),
            jresize.cv2_resize_matrix(i, o, "nearest"))
    x = _x((2,) + hw + (3,), 1) * 1000
    want = np.asarray(jresize.resize(jnp.asarray(x), out, "nearest"))
    got = tresize.resize(_t(x), out, "nearest").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tresize.resize(_t(x[0]), out, "nearest").numpy(), want[0])


# ---------------------------------------------------------------- modules


def _flax(module, *args, seed=0):
    """Random flax params of `module` for `args`, from numpy (no init
    compile): kernels at kaiming scale, IN scales near 1, biases small."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        a = rng.standard_normal(s.shape)
        if len(s.shape) == 4:
            a *= np.sqrt(2.0 / np.prod(s.shape[:3]))
        else:
            a = a * 0.05 + (1.0 if name == "scale" else 0.0)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _f64(jnet, params, *args):
    """JAX's forward in float64."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        out = jax.jit(jnet.apply)({"params": p64}, *(
            jnp.asarray(a, jnp.float64) for a in args))
        return np.asarray(out)


def test_spade_and_lip_encoder_match_jax():
    """SPADE (C 16 at 8², its map at 64², nearest-resized) within 1e-5 of
    max|ref|, and the LIP encoder (5 halvings of 64²) within 1e-4 (in
    float64 it is held inside HiFaceGAN's); the ports take NCHW features,
    as they run inside the generator."""
    from image_restoration_tpu.archs import hifacegan_arch as jha
    x, seg = _x((2, 8, 8, 16), 2), _x((2, 64, 64, 3), 3)
    jm = jha.SPADE(16)
    params = _flax(jm, x, seg)
    tm = tha.SPADE(16)
    tm.load_state_dict(hifacegan_state_dict_from_jax(tm, params))
    want = jax.jit(jm.apply)({"params": params}, x, seg)
    got = tm(_t(x).permute(0, 3, 1, 2), _t(seg)).permute(0, 2, 3, 1)
    assert _rel(got.detach(), want) <= 1e-5
    assert tha.SPADE(256).mlp_shared[0].out_channels == 128

    img = _x((2, 64, 64, 3), 4)
    jm = jha.LIPEncoder(8, 5)
    params = _flax(jm, img, seed=5)
    tm = tha.LIPEncoder(3, 8, 5)
    tm.load_state_dict(hifacegan_state_dict_from_jax(tm, params))
    want = jax.jit(jm.apply)({"params": params}, img)
    got = tm(_t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 2, 2, 128)
    assert _rel(got.detach(), want) <= 1e-4


def _gen_pair(opt, seed=6):
    jnet = jax_build(opt)
    x = _x((2, 64, 64, 3), seed)
    params = _flax(jnet, x, seed=seed)
    tnet = build_network(opt)
    tnet.load_state_dict(hifacegan_state_dict_from_jax(tnet, params))
    return jnet, params, tnet, x


@pytest.mark.parametrize("opt", [G, dict(type="SPADEGenerator", num_feat=8)],
                         ids=["HiFaceGAN", "SPADEGenerator"])
def test_generators_match_jax(opt):
    """HiFaceGAN (LIP encoder) and SPADEGenerator (nearest seed + fc) at
    phase 4: ≤1e-4 of max|ref| in float32 and ≤1e-10 in float64 (JAX
    under x64). The step tests run a phase-1 generator."""
    jnet, params, tnet, x = _gen_pair(opt)
    want = jax.jit(jnet.apply)({"params": params}, x)
    with torch.no_grad():
        got = tnet(_t(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4
    with torch.no_grad():
        got = tnet.double()(torch.from_numpy(x).double())
    assert _rel(got.numpy(), _f64(jnet, params, x)) <= 1e-10


def test_discriminator_matches_jax():
    """The multi-scale D on cat(lq, img) (6 channels, conditional_d):
    every group's output at both scales within 1e-5 of max|ref|."""
    jnet = jax_build(D)
    x = _x((2, 64, 64, 6), 7)
    params = _flax(jnet, x, seed=7)
    tnet = build_network(D)
    assert tnet.discriminator_0.model0[0].in_channels == 6
    tnet.load_state_dict(hifacegan_state_dict_from_jax(tnet, params))
    want = jax.jit(jnet.apply)({"params": params}, x)
    with torch.no_grad():
        got = tnet(_t(x))
    assert len(got) == len(want) == 2
    for gd, wd in zip(got, want):
        assert len(gd) == len(wd) == 5
        for g, w in zip(gd, wd):
            assert g.shape == w.shape and _rel(g, w) <= 1e-5


def _sn_state_dict(net, seed):
    """A BasicSR-layout state_dict of `net`: every conv that BasicSR wraps
    in spectral_norm as (weight_orig, weight_u, weight_v)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        a = rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
        spectral = k.endswith("weight") and v.dim() == 4 and (
            ".conv_" in k or (".model" in k and ".0.0." in k))
        if spectral:
            base = k[:-len("weight")]
            sd[base + "weight_orig"] = a
            sd[base + "weight_u"] = rng.normal(0, 1, v.shape[0]).astype(
                np.float32)
            sd[base + "weight_v"] = rng.normal(0, 1, v[0].numel()).astype(
                np.float32)
        else:
            sd[k] = a
    return sd


def test_fold_spectral_norm_matches_jax(tmp_path):
    """`fold_spectral_norm` equal to JAX's on a BasicSR-layout checkpoint
    of both nets; the checkpoint (a `.pth` under "params") loads strictly
    through `load_hifacegan` and through a plain `load_state_dict` (the
    convs fold the triples as they read them), to the same weights."""
    for opt in (G, D):
        net = build_network(opt)
        sd = _sn_state_dict(net, 8)
        assert any(k.endswith("weight_orig") for k in sd)
        want = jax_fold(sd)
        got = fold_spectral_norm(sd)
        assert sorted(got) == sorted(want) == sorted(net.state_dict())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        torch.save({"params": {k: torch.from_numpy(v) for k, v in
                               sd.items()}}, tmp_path / "ref.pth")
        load_hifacegan(str(tmp_path / "ref.pth"), net)
        for k, v in net.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        other = build_network(opt)
        other.load_state_dict({k: torch.from_numpy(v) for k, v in
                               sd.items()}, strict=True)
        for k, v in other.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# ------------------------------------------------------------ the model


SGD = {"type": "SGD", "lr": 1e-3}
PERCEPTUAL = {"type": "PerceptualLoss",
              "layer_weights": {"relu1_1": 0.5, "relu2_1": 1.0},
              "vgg_type": "vgg19", "use_input_norm": False,
              "range_norm": False, "perceptual_weight": 10.0,
              "style_weight": 0, "criterion": "l1"}
FEAT = {"type": "GANFeatLoss", "loss_weight": 10.0, "criterion": "l1"}


# the step tests' G: 2 halvings and phase 1 (fc, ups 1-3 and to_rgbs 1-3
# unused), so the net is small and the unused-key path is exercised
G_STEP = dict(type="HiFaceGAN", num_feat=8, scale_ratio=2, is_train=True,
              init_train_phase=0)


def _opt(tmp, feat_key, perceptual=True):
    t = {"optim_g": SGD, "optim_d": SGD,
         "scheduler": {"type": "MultiStepLR", "milestones": [1000],
                       "gamma": 0.5},
         "total_iter": 1000, "ema_decay": 0.9,
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
         "perceptual_opt": PERCEPTUAL if perceptual else None,
         "gan_opt": {"type": "MultiScaleGANLoss", "gan_type": "lsgan",
                     "real_label_val": 1.0, "fake_label_val": 0.0,
                     "loss_weight": 1.0},
         feat_key: FEAT, "net_d_iters": 1, "net_d_init_iters": 0}
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "scale": 1, "gt_size": 64, "model_type": "HiFaceGANModel",
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis"),
                     "pretrain_network_g": None},
            "logger": {"print_freq": 1}, "network_g": dict(G_STEP),
            "network_d": dict(D, conditional_d=True),
            "train": {k: v for k, v in t.items() if v is not None}}


@pytest.fixture(scope="module")
def jax_hifacegan(tmp_path_factory):
    """JAX's HiFaceGANModel (its feature matching under `feat_opt`, the
    key it reads) with perturbed G and D; tests restore its first
    state."""
    tmp = tmp_path_factory.mktemp("hifacegan")
    opt = _opt(tmp, "feat_opt")
    jm = jax_build_model(copy.deepcopy(opt))
    pg = _perturb(jm.state["params_g"], 21)
    jm.state = dict(jm.state, params_g=pg, ema_g=pg,
                    params_d=_perturb(jm.state["params_d"], 22))
    return jm, dict(jm.state), tmp


def _pair(jax_hifacegan):
    """The JAX model at its first state and a port model (feature matching
    under `feature_matching_opt`) holding the same G, D and VGG."""
    jm, state, tmp = jax_hifacegan
    jm.state = dict(state)
    port = build_model(_opt(tmp, "feature_matching_opt"), device="cpu")
    g = hifacegan_state_dict_from_jax(port.net_g, state["params_g"])
    port.net_g.load_state_dict(g)
    port.net_g_ema.load_state_dict(g)
    port.net_d.load_state_dict(hifacegan_state_dict_from_jax(
        port.net_d, state["params_d"]))
    port.cri_perceptual.vgg.load_state_dict(vgg_state_dict_from_jax(
        port.cri_perceptual.vgg, jm.cri_perceptual.vgg_variables["params"]))
    return jm, port


def _batch(seed=23):
    rng = np.random.default_rng(seed)
    gt = rng.random((2, 64, 64, 3)).astype(np.float32)
    return {"lq": np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32), "gt": gt}


def test_hifacegan_step_matches_jax(jax_hifacegan):
    """One G+D step (pixel, perceptual, multi-scale lsgan, feature
    matching; SGD, as the ESRGAN step test uses, EMA): every loss ≤1e-5
    relative, then G, EMA and D parameters ≤1e-5 of max|p|, against JAX's
    jitted step. D sees the image alone in both (3 input channels)."""
    jm, port = _pair(jax_hifacegan)
    assert port.net_d.discriminator_0.model0[0].in_channels == 3
    assert jm.state["params_d"]["discriminator_0"]["model0_0"][
        "kernel"].shape[2] == 3
    batch = _batch()
    want = jm.optimize_parameters(1, dict(batch), jax.random.PRNGKey(0))
    got = port.optimize_parameters(1, dict(batch))
    assert {"l_g_pix", "l_g_percep", "l_g_gan", "l_d", "l_d_real",
            "l_d_fake", "real_score", "fake_score"} == set(got) == set(want)
    _check_losses(got, want)
    conv = hifacegan_state_dict_from_jax
    _check_params(port.net_g, jm.state["params_g"], lr=0, convert=conv)
    _check_params(port.net_g_ema, jm.state["ema_g"], lr=0, convert=conv)
    _check_params(port.net_d, jm.state["params_d"], lr=0, convert=conv)
    assert port.iter == 1 and port.optimizer_d.count == 1


def test_hifacegan_loss_gradients_match_jax(jax_hifacegan):
    """At one output image: G's GAN + feature-matching loss and its
    gradient with respect to the output (D taking none), and the D losses
    with D's gradients, against `jax.value_and_grad` of JAX's terms."""
    jm, port = _pair(jax_hifacegan)
    gt, out = _batch(24)["gt"], _batch(25)["gt"]
    pd = jm.state["params_d"]
    jl, jg = jax.jit(jax.value_and_grad(lambda o: jm._gan_g_loss(
        pd, o, jnp.asarray(gt))))(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    port.net_d.requires_grad_(False)
    lg = port._gan_g_loss(o, torch.from_numpy(gt))
    lg.backward()
    port.net_d.requires_grad_(True)
    assert all(p.grad is None for p in port.net_d.parameters())
    _check_losses({"g": lg}, {"g": jl})
    assert float((o.grad - _t(jg)).abs().max()) <= \
        1e-5 * float(np.abs(np.asarray(jg)).max())

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._gan_d_losses(p, jnp.asarray(out), jnp.asarray(gt)),
        has_aux=True))(pd)
    l_d, parts = port._gan_d_losses(o.detach(), torch.from_numpy(gt))
    l_d.backward()
    _check_losses(dict(parts, l_d=l_d), dict(jparts, l_d=jl))
    want = hifacegan_state_dict_from_jax(
        port.net_d, jax.tree_util.tree_map(np.asarray, jgrads))
    scale = max(float(w.abs().max()) for w in want.values())
    for n, p in port.net_d.named_parameters():
        assert float((p.grad - want[n]).abs().max()) <= 1e-5 * scale, n


def test_feature_matching_option_finding(jax_hifacegan, tmp_path):
    """JAX reads `train.feat_opt`, so for the shipped config (whose term
    is `feature_matching_opt`) its ×10 feature matching never runs; the
    port reads `feature_matching_opt`. Under the shipped key: JAX's G GAN
    loss equals the port's without the term, and the port's with it is
    larger by exactly that term."""
    import yaml
    with open(TRAIN_YML) as f:
        shipped = yaml.safe_load(f)["train"]
    assert "feature_matching_opt" in shipped and "feat_opt" not in shipped
    _, state, _ = jax_hifacegan
    opt = _opt(tmp_path, "feature_matching_opt", perceptual=False)
    opt["network_g"]["num_feat"] = 4
    jm = jax_build_model(copy.deepcopy(opt))
    assert jm.cri_feat is None
    port = build_model(opt, device="cpu")
    assert port.cri_feat is not None
    port.net_d.load_state_dict(hifacegan_state_dict_from_jax(
        port.net_d, state["params_d"]))
    gt, out = _batch(26)["gt"], _batch(27)["gt"]
    want = float(jax.jit(lambda o: jm._gan_g_loss(
        state["params_d"], o, jnp.asarray(gt)))(jnp.asarray(out)))
    with torch.no_grad():
        with_feat = float(port._gan_g_loss(_t(out), _t(gt)))
        term = float(port.cri_feat(port.net_d(_t(out)),
                                   port.net_d(_t(gt))))
        port.cri_feat = None
        without = float(port._gan_g_loss(_t(out), _t(gt)))
    assert abs(without - want) <= 1e-5 * abs(want)
    assert term > 0 and abs(with_feat - without - term) <= 1e-5 * with_feat


# ---------------------------------------------------- the configs end to end


def _pairs(root, n, seed, hw=64):
    for sub in ("gt", "lq"):
        os.makedirs(root / sub, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        gt = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"face_{i}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"face_{i}.png"), cv2.GaussianBlur(
            gt, (5, 5), 1.5))


def test_configs_train_then_test(tmp_path):
    """train_hifacegan.yml at num_feat 8 (D 8, two VGG taps) on 64² pairs:
    2 steps through `train_pipeline`, every loss finite, the feature
    matching on; then both test configs through `test_pipeline` on the
    run's `net_g_2.pth`: PSNR/SSIM where there is a GT, the images
    written."""
    _pairs(tmp_path / "train", 2, 28)
    _pairs(tmp_path / "val", 2, 29)
    model = train_pipeline(str(tmp_path), argv=[
        "-opt", TRAIN_YML, "--force_yml",
        f"datasets:train:dataroot_gt={tmp_path}/train/gt",
        f"datasets:train:dataroot_lq={tmp_path}/train/lq",
        f"datasets:val:dataroot_gt={tmp_path}/val/gt",
        f"datasets:val:dataroot_lq={tmp_path}/val/lq",
        "datasets:train:gt_size=64", "network_g:num_feat=8",
        "network_d:num_feat=8", "train:total_iter=2",
        "train:perceptual_opt:layer_weights={relu1_1: 0.5, relu2_1: 1.0}",
        "val:val_freq=2", "logger:save_checkpoint_freq=2",
        "logger:use_tb_logger=false"], device="cpu")
    assert model.iter == 2 and model.cri_feat is not None
    assert {"l_g_percep", "l_g_gan", "l_d"} <= set(model.log_dict)
    assert all(np.isfinite(v) for v in model.log_dict.values())
    ckpt = tmp_path / "experiments" / "HiFaceGAN_SR4x_train" / "models" / \
        "net_g_2.pth"
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", TEST_YML, "--force_yml",
        f"datasets:test_gt:dataroot_gt={tmp_path}/val/gt",
        f"datasets:test_gt:dataroot_lq={tmp_path}/val/lq",
        f"path:pretrain_network_g={ckpt}", "network_g:num_feat=8"],
        device="cpu")
    assert np.isfinite(res["FFHQ_sr4x_val"]["psnr"])
    assert -1 <= res["FFHQ_sr4x_val"]["ssim"] <= 1
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", TEST_WOGT_YML, "--force_yml",
        f"datasets:test_wild:dataroot_lq={tmp_path}/val/lq",
        f"path:pretrain_network_g={ckpt}", "network_g:num_feat=8"],
        device="cpu")
    assert res == {"FFHQ_in_the_wild": {}}
    for name, n in (("HiFaceGAN_SR4x_test", 2), ("HiFaceGAN_generic_test", 2)):
        vis = tmp_path / "results" / name / "visualization"
        assert len(list(vis.iterdir())) == n, name
