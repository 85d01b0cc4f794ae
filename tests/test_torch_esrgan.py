"""The port's discriminators, SRGANModel, ESRGANModel and `test.py` against
the JAX package.

Tiny sizes: an RRDBNet G of 1 block and 8 features (×4, 32² → 128²), the
VGG-style D at num_feat 4, batch 2, the perceptual loss at conv1_2. The
same numpy-seeded batch and weights (flax params and BatchNorm statistics,
perturbed, carried by `convert/from_jax.py`) go to both sides.
Tolerances: D forwards ≤1e-5 absolute, and so the mean logits
(`real_score`, `fake_score`); the refreshed running statistics ≤1e-6
(≤1e-4 after a whole step, see `test_gan_steps_match_jax`);
losses ≤1e-5 relative; parameters after Adam steps as
`test_torch_sr_train._check_params` states; PSNR within 1e-3 dB.
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
from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu.test import test_pipeline as jax_test_pipeline
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.test import \
    test_pipeline as port_test_pipeline
from image_restoration_tpu_torch.train import train_pipeline
from test_torch_sr_train import _check_losses, _check_params, _perturb

RRDB_G = {"type": "RRDBNet", "num_feat": 8, "num_block": 1,
          "num_grow_ch": 4, "scale": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_d(typ, size, seed=0, **kw):
    """(flax net, variables with perturbed params and positive running
    variances, port net holding the same)."""
    jnet = jax_build(dict(type=typ, num_in_ch=3, num_feat=4, **kw))
    v = dict(jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, size, size, 3))))
    v = {"params": _perturb(v["params"], seed + 1),
         **({"batch_stats": jax.tree_util.tree_map(
             lambda a: np.abs(a) + 0.5, _perturb(v["batch_stats"], seed + 2))}
            if "batch_stats" in v else {})}
    net = build_network(dict(type=typ, num_in_ch=3, num_feat=4, **kw))
    net.load_state_dict(discriminator_state_dict_from_jax(net, v),
                        strict=True)
    return jnet, v, net


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _x(n, size, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("typ,size", [("VGGStyleDiscriminator128", 128),
                                      ("VGGStyleDiscriminator256", 256),
                                      ("UNetDiscriminatorSN", 32)])
def test_discriminator_forward_matches_jax(typ, size):
    """Train mode (batch statistics) and, for the BatchNorm Ds, eval mode
    (running statistics)."""
    jnet, v, net = _jax_d(typ, size)
    x = _x(2, size, 3)
    has_stats = "batch_stats" in v
    want = jnet.apply(v, jnp.asarray(x), **(
        dict(train=True, mutable=["batch_stats"]) if has_stats else {}))
    want = want[0] if has_stats else want
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if has_stats:
        net.eval()
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jnet.apply(
            v, jnp.asarray(x))), rtol=0, atol=1e-5)


def test_spectral_conv_loads_reference_keys():
    """A reference checkpoint (torch's spectral_norm: weight_orig,
    weight_u, weight_v) loads strictly; σ is the fixed-start estimate."""
    _, _, net = _jax_d("UNetDiscriminatorSN", 32)
    sd = dict(net.state_dict())
    sd["conv1.weight_u"] = torch.zeros(8)
    sd["conv1.weight_v"] = torch.zeros(4 * 16)
    net.load_state_dict(sd, strict=True)
    w = net.conv1.weight_orig.detach().permute(2, 3, 1, 0).reshape(-1, 8)
    sigma = float(torch.linalg.matrix_norm(w, ord=2))
    assert abs(float(net.conv1.sigma()) - sigma) <= 0.05 * sigma


# --------------------------------------------------- SRGAN / ESRGAN steps


def _opt(tmp, model_type, **train):
    t = {"optim_g": {"type": "Adam", "lr": 1e-3},
         "optim_d": {"type": "Adam", "lr": 1e-3},
         "scheduler": {"type": "MultiStepLR", "milestones": [1000],
                       "gamma": 0.5},
         "total_iter": 1000, "ema_decay": 0.9,
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2},
         "perceptual_opt": {"type": "PerceptualLoss",
                            "layer_weights": {"conv1_2": 1},
                            "vgg_type": "vgg19", "use_input_norm": True,
                            "range_norm": False, "perceptual_weight": 1.0,
                            "style_weight": 0, "criterion": "l1"},
         "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                     "loss_weight": 5e-3},
         "net_d_iters": 1, "net_d_init_iters": 1}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "scale": 4, "gt_size": 128, "model_type": model_type,
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis"),
                     "pretrain_network_g": None},
            "logger": {"print_freq": 1}, "network_g": dict(RRDB_G),
            "network_d": {"type": "VGGStyleDiscriminator128",
                          "num_in_ch": 3, "num_feat": 4},
            "train": t}


SGD = {"type": "SGD", "lr": 1e-3}


@pytest.fixture(scope="module")
def jax_gan_models(tmp_path_factory):
    """One JAX model of each type (building one takes ~10 s), with SGD
    (see `test_gan_steps_match_jax`) and perturbed weights; tests restore
    its first state."""
    tmp = tmp_path_factory.mktemp("gan")
    models = {}
    for model_type in ("SRGANModel", "ESRGANModel"):
        opt = _opt(tmp, model_type, optim_g=SGD, optim_d=SGD)
        jm = jax_build_model(copy.deepcopy(opt))
        pg = _perturb(jm.state["params_g"], 21)
        stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5,
                                       _perturb(jm.state["stats_d"], 23))
        jm.state = dict(jm.state, params_g=pg, ema_g=pg,
                        params_d=_perturb(jm.state["params_d"], 22),
                        stats_d=stats)
        models[model_type] = (jm, dict(jm.state), opt)
    return models


def _gan_pair(jax_gan_models, model_type):
    """The cached JAX model at its first state, and a port model holding
    the same G, D (with statistics) and VGG weights."""
    jm, state, opt = jax_gan_models[model_type]
    jm.state = dict(state)
    port = build_model(opt, device="cpu")
    g = state_dict_from_jax(port.net_g, state["params_g"])
    port.net_g.load_state_dict(g)
    port.net_g_ema.load_state_dict(g)
    port.net_d.load_state_dict(discriminator_state_dict_from_jax(
        port.net_d, {"params": state["params_d"],
                     "batch_stats": state["stats_d"]}))
    port.cri_perceptual.vgg.load_state_dict(vgg_state_dict_from_jax(
        port.cri_perceptual.vgg, jm.cri_perceptual.vgg_variables["params"]))
    return jm, port


def _gan_batch(seed=24):
    rng = np.random.default_rng(seed)
    gt = rng.random((2, 128, 128, 3)).astype(np.float32)
    lq = cv2.resize(gt.transpose(1, 2, 0, 3).reshape(128, 128, 6), (32, 32),
                    interpolation=cv2.INTER_AREA)
    return {"lq": lq.reshape(32, 32, 2, 3).transpose(2, 0, 1, 3).copy(),
            "gt": gt}


def _check_gan_losses(got, want):
    """Losses ≤1e-5 relative; the mean logits are D forwards, ≤1e-5
    absolute (BatchNorm at batch 2 normalizes by E[x²] − E[x]², which
    amplifies float32 rounding into their last digits)."""
    scores = ("real_score", "fake_score")
    _check_losses({k: v for k, v in got.items() if k not in scores},
                  {k: v for k, v in want.items() if k not in scores})
    for k in scores:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k


def _d_params_from_jax(net, variables):
    """D's parameters only (its statistics are `_check_d_stats`')."""
    return {k: v for k, v in discriminator_state_dict_from_jax(
        net, variables).items() if "running" not in k}


def _check_d_stats(net_d, stats, atol=1e-6, rtol=0.0):
    for name, m in net_d.named_modules():
        if name.startswith("bn"):
            np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(
                stats[name]["mean"]), rtol=rtol, atol=atol, err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(), np.asarray(
                stats[name]["var"]), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("model_type", ["SRGANModel", "ESRGANModel"])
def test_gan_steps_match_jax(jax_gan_models, model_type):
    """Iteration 1 is a skipped G iteration (net_d_init_iters 1: no G
    update, its optimizer untouched, EMA and D step all the same);
    iteration 2 a full one. Losses, G, EMA and D params, and D's running
    statistics after both; against JAX's step run eagerly. D with
    BatchNorm at batch 2 is sensitive: its first layers' gradients move
    ~1e-5 relative per 1e-7 of change in its input, and JAX's jitted G
    output is ~4e-6 from its eager one (which the port's equals here).
    For the same reason SGD with momentum (optax's `sgd` against torch's;
    Adam against optax is held in tests/test_torch_train_losses.py):
    Adam's first steps turn a gradient that cancels to float32 rounding of
    0 into a step of up to lr. D's statistics, refreshed by the updated D
    (its deepest BatchNorm sees 32 values a channel), are held at 1e-4;
    `_refresh_d_stats` alone is held at 1e-6 below."""
    jm, port = _gan_pair(jax_gan_models, model_type)
    batch = _gan_batch()
    g0 = copy.deepcopy(port.net_g.state_dict())
    with jax.disable_jit():
        want = jm.optimize_parameters(1, dict(batch), jax.random.PRNGKey(0))
    got = port.optimize_parameters(1, dict(batch))
    _check_gan_losses(got, want)
    assert not any(k.startswith("l_g") for k in got)
    assert port.optimizer_g.count == 0 and not port.optimizer_g.opt.state \
        and port.optimizer_d.count == 1
    for k, v in port.net_g.state_dict().items():
        assert torch.equal(v, g0[k]), k
    _check_d_stats(port.net_d, jm.state["stats_d"], atol=1e-4)
    with jax.disable_jit():
        want = jm.optimize_parameters(2, dict(batch), jax.random.PRNGKey(0))
    got = port.optimize_parameters(2, dict(batch))
    _check_gan_losses(got, want)
    assert {"l_g_pix", "l_g_percep", "l_g_gan", "l_d"} <= set(got)
    _check_params(port.net_g, jm.state["params_g"], lr=0)
    _check_params(port.net_g_ema, jm.state["ema_g"], lr=0)
    _check_params(port.net_d, {"params": jm.state["params_d"],
                               "batch_stats": jm.state["stats_d"]},
                  lr=0, convert=_d_params_from_jax)
    _check_d_stats(port.net_d, jm.state["stats_d"], atol=1e-4)
    assert port.optimizer_g.count == 1 and port.optimizer_d.count == 2


@pytest.mark.parametrize("model_type", ["SRGANModel", "ESRGANModel"])
def test_gan_losses_and_grads_match_jax(jax_gan_models, model_type):
    """At one output image: the GAN part of G's loss (relativistic for
    ESRGAN, every stop-gradient where JAX puts it) and its gradient with
    respect to the output, leaving no gradient on D; and the D losses and
    D's gradients; against `jax.value_and_grad` of JAX's own terms."""
    jm, port = _gan_pair(jax_gan_models, model_type)
    gt, out = _x(2, 128, 25) * 0.5 + 0.5, _x(2, 128, 26) * 0.5 + 0.5
    st = jm.state["stats_d"]
    jl, jg = jax.jit(jax.value_and_grad(lambda o: jm._gan_g_loss(
        jm.state["params_d"], o, jnp.asarray(gt), stats=st)))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    port.net_d.requires_grad_(False)
    lg = port._gan_g_loss(o, torch.from_numpy(gt))
    lg.backward()
    port.net_d.requires_grad_(True)
    assert all(p.grad is None for p in port.net_d.parameters())
    _check_losses({"g": lg}, {"g": jl})
    scale = float(np.abs(np.asarray(jg)).max())
    assert float((o.grad - _t(jg)).abs().max()) <= 1e-5 * scale

    def d_loss(pd):
        return jm._gan_d_losses(pd, jnp.asarray(out), jnp.asarray(gt),
                                stats=st)

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(
        jm.state["params_d"])
    l_d, parts = port._gan_d_losses(o.detach(), torch.from_numpy(gt))
    l_d.backward()
    _check_gan_losses(dict(parts, l_d=l_d), dict(jparts, l_d=jl))
    _check_grads(port.net_d, discriminator_state_dict_from_jax(
        port.net_d, {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                     "batch_stats": st}))


def _check_grads(net, want, tol=1e-5):
    scale = max(float(want[n].abs().max()) for n, _ in
                net.named_parameters())
    for name, p in net.named_parameters():
        d = float((p.grad - want[name]).abs().max())
        assert d <= tol * scale, (name, d, scale)


def test_refresh_d_stats_matches_jax(jax_gan_models):
    """`_refresh_d_stats` (from the GT, then the output) ≤1e-6."""
    jm, port = _gan_pair(jax_gan_models, "SRGANModel")
    gt, out = _x(2, 128, 26), _x(2, 128, 27)
    want = jm._refresh_d_stats(jm.state["params_d"], jm.state["stats_d"],
                               jnp.asarray(out), jnp.asarray(gt))
    port._refresh_d_stats(torch.from_numpy(out), torch.from_numpy(gt))
    _check_d_stats(port.net_d, want)


# ------------------------------------------------------ test.py and CLIs


def _pairs(root, n, seed, scale=4, hw=32):
    os.makedirs(root / "gt", exist_ok=True)
    os.makedirs(root / "lq", exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        gt = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"img_{i}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"img_{i}.png"), cv2.resize(
            gt, (hw // scale, hw // scale), interpolation=cv2.INTER_AREA))


def test_test_pipeline_matches_jax(tmp_path):
    """configs/test_esrgan_x4.yml's shape at a tiny RRDBNet from one `.pth`
    on a synthetic paired folder: PSNR and SSIM within 1e-3 dB (and 1e-5)
    of JAX's test pipeline, and the restored images written."""
    _pairs(tmp_path, 3, 28)
    net = build_network(RRDB_G, torch.Generator().manual_seed(1))
    torch.save({"params_ema": net.state_dict()}, tmp_path / "g.pth")
    argv = ["-opt", "configs/test_esrgan_x4.yml", "--force_yml",
            f"datasets:test_1:dataroot_gt={tmp_path}/gt",
            f"datasets:test_1:dataroot_lq={tmp_path}/lq",
            f"path:pretrain_network_g={tmp_path}/g.pth",
            "network_g:num_feat=8", "network_g:num_block=1",
            "network_g:num_grow_ch=4"]
    got = port_test_pipeline(str(tmp_path / "port"), argv=argv, device="cpu")
    want = jax_test_pipeline(str(tmp_path / "jax"), argv=argv)
    assert set(got) == set(want) == {"Set14"}
    assert abs(got["Set14"]["psnr"] - want["Set14"]["psnr"]) <= 1e-3
    assert abs(got["Set14"]["ssim"] - want["Set14"]["ssim"]) <= 1e-5
    vis = tmp_path / "port" / "results" / "test_ESRGAN_x4" / "visualization"
    assert len(list(vis.iterdir())) == 3


def test_esrgan_config_trains_then_tests(tmp_path):
    """configs/train_esrgan_x4.yml at the tiny widths through
    `train_pipeline` (paired 128² crops, VGG-style D, 2 iterations,
    validation and a checkpoint), then `test.py` with
    configs/test_esrgan_x4.yml on the run's `net_g_2.pth`."""
    _pairs(tmp_path / "train", 2, 29, hw=136)
    _pairs(tmp_path / "val", 1, 30)
    model = train_pipeline(str(tmp_path), argv=[
        "-opt", "configs/train_esrgan_x4.yml", "--force_yml",
        f"datasets:train:dataroot_gt={tmp_path}/train/gt",
        f"datasets:train:dataroot_lq={tmp_path}/train/lq",
        f"datasets:val:dataroot_gt={tmp_path}/val/gt",
        f"datasets:val:dataroot_lq={tmp_path}/val/lq",
        "datasets:train:batch_size_per_gpu=2", "network_g:num_feat=8",
        "network_g:num_block=1", "network_g:num_grow_ch=4",
        "network_d:num_feat=4", "train:total_iter=2",
        "train:perceptual_opt:layer_weights={conv1_2: 1}",
        "val:val_freq=2", "logger:save_checkpoint_freq=2",
        "logger:use_tb_logger=false"], device="cpu")
    assert model.iter == 2 and model.optimizer_d.count == 2
    assert {"l_g_pix", "l_g_percep", "l_g_gan", "l_d"} <= \
        set(model.log_dict)
    assert all(np.isfinite(v) for v in model.log_dict.values())
    ckpt = tmp_path / "experiments" / "train_ESRGAN_x4" / "models" / \
        "net_g_2.pth"
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", "configs/test_esrgan_x4.yml", "--force_yml",
        f"datasets:test_1:dataroot_gt={tmp_path}/val/gt",
        f"datasets:test_1:dataroot_lq={tmp_path}/val/lq",
        f"path:pretrain_network_g={ckpt}", "network_g:num_feat=8",
        "network_g:num_block=1", "network_g:num_grow_ch=4"], device="cpu")
    assert np.isfinite(res["Set14"]["psnr"]) and \
        -1 <= res["Set14"]["ssim"] <= 1
