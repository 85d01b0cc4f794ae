"""The port's GFPGAN GAN trainer against the JAX package.

One G+D step and one R1 step at the tiny config of
`tests/test_models.py:188-233` (32², num_style_feat 16, D at channel
multiplier 0.25), with the production losses (pixel, Sobel, pyramid,
perceptual + style, wgan_softplus) and lq, gt and the StyleConv noise
passed in: every loss term and the G and D gradients against
`jax.value_and_grad` of JAX's own loss terms at the same weights (flax
params, perturbed so zero-initialized biases and noise strengths count,
carried by `convert/from_jax.py`). Tolerances: losses ≤1e-5 relative;
gradients ≤1e-4 of the largest |grad| of the network, except that at
most 1 element in 10⁴ may reach 1e-3 of it (a pre-activation within float
rounding of the LeakyReLU kink takes the other slope on one side). Then
the skip iteration, the `fix_decoder` mask, and `train_pipeline` end to
end on the CPU: 4 iterations, a resume, and the saved `net_g_*.pth` served
by `Restorer(ckpt_path=...)`.
"""

import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu_torch.convert import (state_dict_from_jax,
                                                 vgg_state_dict_from_jax)
from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.train import train_pipeline

TINY_G = dict(type="GFPGANv1OCR", input_width=32, input_height=32,
              num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
              input_is_latent=True, different_w=True, narrow=0.5,
              sft_half=True, fix_decoder=False)
TINY_D = dict(type="StyleGAN2Discriminator", input_width=32,
              input_height=32, channel_multiplier=0.25, narrow=0.25)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(tmp, **train):
    t = {
        "optim_g": {"type": "Adam", "lr": 2e-3},
        "optim_d": {"type": "Adam", "lr": 2e-3},
        "scheduler": {"type": "MultiStepLR", "milestones": [100],
                      "gamma": 0.5},
        "total_iter": 6,
        "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
        "sobel_opt": {"type": "SobelLoss", "loss_weight": 0.2},
        "L1_opt": {"type": "L1Loss", "loss_weight": 1.0},
        "perceptual_opt": {
            "type": "PerceptualLoss",
            "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                              "conv4_4": 1, "conv5_4": 1},
            "vgg_type": "vgg19", "use_input_norm": True,
            "perceptual_weight": 1.0, "style_weight": 50,
            "range_norm": True, "criterion": "l1"},
        "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                    "loss_weight": 0.1},
        "pyramid_loss_weight": 1.0, "remove_pyramid_loss": 3,
        "r1_reg_weight": 10, "net_d_iters": 1, "net_d_init_iters": 0,
        "net_d_reg_every": 2}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis")},
            "logger": {"print_freq": 1}, "model_type": "GFPGANModel",
            "network_g": dict(TINY_G), "network_d": dict(TINY_D),
            "train": t}


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)


def _carry(port, jm):
    """The JAX model's (perturbed) G, D and VGG weights into the port
    model; returns the flax trees."""
    pg = _perturb(jm.state["params_g"], 1)
    pd = _perturb(jm.state["params_d"], 2)
    pv = jm.cri_perceptual.vgg_variables["params"]
    sd_g = state_dict_from_jax(port.net_g, pg)
    port.net_g.load_state_dict(sd_g)
    port.net_g_ema.load_state_dict(sd_g)
    port.net_d.load_state_dict(state_dict_from_jax(port.net_d, pd))
    port.cri_perceptual.vgg.load_state_dict(
        vgg_state_dict_from_jax(port.cri_perceptual.vgg, pv))
    return pg, pd


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gfpgan")
    opt = _opt(tmp)
    jm = jax_build_model(copy.deepcopy(opt))
    port = build_model(opt, device="cpu")
    pg, pd = _carry(port, jm)
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lq = np.clip(gt + rng.normal(0, 0.2, gt.shape), -1, 1).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in port.net_g.stylegan_decoder.noise_shapes()]
    return dict(jm=jm, port=port, pg=pg, pd=pd, lq=lq, gt=gt, noise=noise,
                tmp=tmp)


def _jax_g_loss(jm, pg, pd, lq, gt, noise, pyr_w):
    """JAX's G loss terms as `gfpgan_model.py:243-290` sums them."""
    output, out_rgbs = jm.net_g.apply({"params": pg}, lq, return_rgb=True,
                                      noise=noise)
    losses = {"l_g_pix": jm.cri_pix(output, gt),
              "l_g_sobel": jm.cri_sobel(output, gt)}
    for i, (rgb, pgt) in enumerate(zip(out_rgbs, jm._pyramid_gt(gt))):
        losses[f"l_p_{2 ** (i + 3)}"] = jm.cri_l1(rgb, pgt) * pyr_w
    percep, style = jm.cri_perceptual(output, gt)
    losses["l_g_percep"] = percep
    losses["l_g_style"] = style
    losses["l_g_gan"] = jm.cri_gan(jm.net_d.apply({"params": pd}, output),
                                   True, is_disc=False)
    return sum(losses.values()), (losses, output)


def _check_grads(net, jgrads):
    want = state_dict_from_jax(net, jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    scale = max(float(v.abs().max()) for v in want.values())
    over, total = 0, 0
    for name, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        d = (g - want[name]).abs()
        assert float(d.max()) <= 10 * GRAD_TOL * scale, name
        over += int((d > GRAD_TOL * scale).sum())
        total += d.numel()
    assert over <= total * 1e-4, (over, total)


def _check_losses(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= LOSS_RTOL * abs(w), (k, g, w)


def test_g_step_losses_and_grads_match_jax(pair):
    jm, port = pair["jm"], pair["port"]
    args = [jnp.asarray(pair["lq"]), jnp.asarray(pair["gt"]),
            [jnp.asarray(n) for n in pair["noise"]], 1.0]
    (_, (jlosses, jout)), jgrads = jax.jit(jax.value_and_grad(
        lambda pg: _jax_g_loss(jm, pg, pair["pd"], *args), has_aux=True))(
        pair["pg"])
    port.net_g.zero_grad()
    port.net_d.requires_grad_(False)
    total, losses, out = port.g_losses(
        torch.from_numpy(pair["lq"]), torch.from_numpy(pair["gt"]),
        [torch.from_numpy(n) for n in pair["noise"]], 1.0)
    total.backward()
    port.net_d.requires_grad_(True)
    assert all(p.grad is None for p in port.net_d.parameters())
    _check_losses(losses, jlosses)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    _check_grads(port.net_g, jgrads)
    port.net_g.zero_grad()


def test_d_step_losses_and_grads_match_jax(pair):
    """The D logistic loss at the (detached) G output, and its D
    gradients."""
    jm, port = pair["jm"], pair["port"]
    rng = np.random.default_rng(4)
    out = rng.uniform(-1, 1, pair["gt"].shape).astype(np.float32)
    gt = jnp.asarray(pair["gt"])

    def d_loss(pd):
        fake = jm.net_d.apply({"params": pd}, jnp.asarray(out))
        real = jm.net_d.apply({"params": pd}, gt)
        return (jm.cri_gan(real, True, is_disc=True)
                + jm.cri_gan(fake, False, is_disc=True),
                (jnp.mean(real), jnp.mean(fake)))

    (jl, (jr, jf)), jgrads = jax.jit(jax.value_and_grad(
        d_loss, has_aux=True))(pair["pd"])
    port.net_d.zero_grad()
    l_d, real_s, fake_s = port.d_loss(torch.from_numpy(out),
                                      torch.from_numpy(pair["gt"]))
    l_d.backward()
    _check_losses({"l_d": l_d, "real": real_s, "fake": fake_s},
                  {"l_d": jl, "real": jr, "fake": jf})
    _check_grads(port.net_d, jgrads)
    port.net_d.zero_grad()


def test_r1_step_loss_and_grads_match_jax(pair):
    """R1 as the trainer weights it (r1/2·reg_every): a double backward
    through D, K1's autograd formula included."""
    from image_restoration_tpu.losses.losses import r1_penalty
    jm, port = pair["jm"], pair["port"]
    weight = jm.r1_reg_weight / 2 * jm.net_d_reg_every

    def r1(pd):
        return weight * r1_penalty(
            lambda x: jm.net_d.apply({"params": pd}, x),
            jnp.asarray(pair["gt"]))

    jl, jgrads = jax.jit(jax.value_and_grad(r1))(pair["pd"])
    port.net_d.zero_grad()
    l_r1 = port.r1_loss(torch.from_numpy(pair["gt"]))
    l_r1.backward()
    _check_losses({"l_d_r1": l_r1}, {"l_d_r1": jl})
    _check_grads(port.net_d, jgrads)
    port.net_d.zero_grad()


def test_pyramid_weight_schedule(pair):
    port = pair["port"]
    assert [port.pyramid_weight(i) for i in (1, 2, 3, 4)] == \
        [1.0, 1.0, 1e-12, 1e-12]


def _fresh(tmp, **train):
    return build_model(_opt(tmp, **train), device="cpu")


def _params(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_skip_iteration_leaves_g_and_its_adam_alone(tmp_path):
    """net_d_init_iters=1: iteration 1 runs no G update (no optimizer step,
    no moments), yet the EMA moves and D trains; iteration 2 updates G."""
    model = _fresh(tmp_path, net_d_init_iters=1, perceptual_opt=None)
    with torch.no_grad():
        for p in model.net_g_ema.parameters():
            p.add_(0.01)
    g0, ema0, d0 = (_params(model.net_g), _params(model.net_g_ema),
                    _params(model.net_d))
    rng = np.random.default_rng(5)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch = {"gt": gt, "lq": gt * 0.5}
    logs = model.optimize_parameters(1, batch)
    assert not any(k.startswith("l_g") for k in logs) and "l_d" in logs
    for k, v in model.net_g.state_dict().items():
        assert torch.equal(v, g0[k]), k
    assert model.optimizer_g.count == 0 and not model.optimizer_g.opt.state
    assert model.optimizer_d.count == 1
    decay = model.ema_decay
    for k, v in model.net_g_ema.state_dict().items():
        torch.testing.assert_close(v, ema0[k] * decay + g0[k] * (1 - decay))
    assert any(not torch.equal(v, d0[k])
               for k, v in model.net_d.state_dict().items())
    logs = model.optimize_parameters(2, batch)
    assert "l_g_gan" in logs and "l_d_r1" in logs
    assert model.optimizer_g.count == 1 and model.optimizer_d.count == 3


@pytest.mark.parametrize("it, parts", [
    (1, ["degradation", "g_forward", "ema", "d_step"]),
    (2, ["degradation", "g_forward_losses", "g_backward", "g_adam", "ema",
         "d_step", "r1"])])
def test_step_marks_and_losses_stay_on_device(tmp_path, it, parts):
    """The step calls `mark` with each part's name in order and None after
    the last (iteration 1 is a skip iteration, 2 an R1 one), and returns
    its losses as detached tensors; `log_dict` holds the same as floats."""
    model = _fresh(tmp_path, net_d_init_iters=1, perceptual_opt=None)
    gt = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    seen = []
    model.mark = seen.append
    if it == 2:
        model.optimize_parameters(1, {"gt": gt, "lq": gt * 0.5})
        seen.clear()
    losses = model.optimize_parameters(it, {"gt": gt, "lq": gt * 0.5})
    assert seen == parts + [None]
    assert losses is model.losses and ("l_d_r1" in losses) == (it == 2)
    assert all(torch.is_tensor(v) and not v.requires_grad
               for v in losses.values())
    assert model.log_dict == {k: float(v) for k, v in losses.items()}


def test_fix_decoder_mask(tmp_path):
    """fix_decoder: the stylegan_decoder subtree gets no update and no
    optimizer state (the parameters JAX's mask trains are the rest);
    everything else trains."""
    opt = _opt(tmp_path, perceptual_opt=None)
    opt["network_g"]["fix_decoder"] = True
    model = build_model(opt, device="cpu")
    g0 = _params(model.net_g)
    gt = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    model.optimize_parameters(1, {"gt": gt, "lq": gt * 0.5})
    trained = {id(p) for p in model.optimizer_g.params}
    for name, p in model.net_g.named_parameters():
        in_dec = name.startswith("stylegan_decoder.")
        assert (id(p) in trained) != in_dec, name
        assert (p in model.optimizer_g.opt.state) != in_dec, name
        if in_dec:
            assert torch.equal(p.detach(), g0[name]), name
    assert sum(not torch.equal(v, g0[k]) for k, v in
               model.net_g.state_dict().items()) > 10
    jm = jax_build_model(copy.deepcopy(opt))
    leaves = jax.tree_util.tree_leaves_with_path(jm.state["params_g"])
    n_jax_trained = sum(1 for path, _ in leaves
                        if path[0].key != "stylegan_decoder")
    assert n_jax_trained == len(model.optimizer_g.params)


def test_train_pipeline_resume_and_restorer(tmp_path):
    """`train_pipeline` on the CONFIG of tests/test_train_pipeline.py for 4
    iterations (R1 at 2 and 4, validation, checkpoints), a resume that
    restores every piece of state, 2 more iterations through
    --auto_resume, then the saved EMA G served by `Restorer`."""
    from test_train_pipeline import CONFIG
    os.makedirs(tmp_path / "gt")
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(str(tmp_path / "gt" / f"img_{i}.png"),
                    (rng.random((40, 40, 3)) * 255).astype(np.uint8))
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(CONFIG.format(root=tmp_path))
    model = train_pipeline(str(tmp_path), argv=["-opt", str(cfg)],
                           device="cpu")
    assert model.iter == 4 and model.optimizer_g.count == 4
    assert all(np.isfinite(v) for v in model.log_dict.values())
    assert "l_d_r1" in model.log_dict
    exp = tmp_path / "experiments" / "debug_tiny_gfpgan"
    assert (exp / "models" / "ckpt_4.pth").exists()
    assert any((exp / "visualization").iterdir())

    again = build_model(model.opt, device="cpu")
    again.resume(str(exp / "models" / "ckpt_4.pth"))
    for a, b in ((again.net_g, model.net_g), (again.net_d, model.net_d),
                 (again.net_g_ema, model.net_g_ema)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert again.iter == 4 and again.optimizer_d.count == 6

    resumed = train_pipeline(str(tmp_path), argv=[
        "-opt", str(cfg), "--auto_resume", "--force_yml",
        "train:total_iter=6"], device="cpu")
    assert resumed.iter == 6 and resumed.optimizer_g.count == 6
    assert (exp / "models" / "net_g_6.pth").exists()

    net_opt = {k: v for k, v in TINY_G.items() if k != "fix_decoder"}
    restorer = Restorer(net_opt, ckpt_path=str(exp / "models" / "net_g_6.pth"),
                        device="cpu")
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    want = resumed.test((x - 0.5) / 0.5).numpy()
    got = restorer.restore_batch(x)
    from image_restoration_tpu_torch.utils.img_util import tensor2img
    ref = np.stack([tensor2img(want[i:i + 1], min_max=(-1, 1))
                    for i in range(2)])
    np.testing.assert_array_equal(got, ref)


def test_trainer_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Unset, the device is cuda: without a GPU the trainer raises rather
    than train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_opt(tmp_path, perceptual_opt=None))
