"""The port's losses, VGG19, StyleGAN2 discriminator, schedules, optimizers
and EMA against the JAX package at the same weights and inputs.

Weights go from flax to the port through `convert/from_jax.py`; inputs are
numpy arrays from a seed; float32 on both sides. Tolerances: losses ≤1e-6
relative, forwards ≤1e-5 of max|ref|, gradients ≤1e-4 of max|grad|,
schedules ≤1e-6 relative, optimizer and EMA parameters ≤1e-6 of max|p|.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.torch_import import import_network
from image_restoration_tpu.losses import losses as JL
from image_restoration_tpu.models.base_model import BaseModel as JaxBase
from image_restoration_tpu.models.lr_scheduler import \
    build_schedule as jax_schedule
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (state_dict_from_jax,
                                                 vgg_state_dict_from_jax)
from image_restoration_tpu_torch.losses import build_loss
from image_restoration_tpu_torch.losses import losses as TL
from image_restoration_tpu_torch.models.base_model import (BaseModel,
                                                           TrainOptimizer)
from image_restoration_tpu_torch.models.lr_scheduler import build_schedule

TINY_D = dict(type="StyleGAN2Discriminator", input_width=32,
              input_height=32, channel_multiplier=0.25, narrow=0.25)
LAYERS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1, "conv4_4": 1,
          "conv5_4": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _rel(got, want, tol=1e-6):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-12), (got, want)


def _close_scaled(got, want, tol):
    """|got − want| ≤ tol · max|want|."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12))


def _pair(seed, shape=(2, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _perturb(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)


# -------------------------------------------------------- simple losses


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "CharbonnierLoss",
                                  "SobelLoss", "WMSELoss"])
def test_pixel_loss_matches_jax(name):
    a, b = _pair(0)
    w = np.random.default_rng(1).random(a.shape[:3] + (1,)).astype(
        np.float32)
    for weight in (None, w):
        jw = None if weight is None else jnp.asarray(weight)
        tw = None if weight is None else _t(weight)
        if name in ("SobelLoss", "WMSELoss") and weight is not None:
            jw, tw = jw[..., :1], tw[..., :1]
        want = getattr(JL, name)(0.7)(jnp.asarray(a), jnp.asarray(b), jw)
        got = build_loss(dict(type=name, loss_weight=0.7))(_t(a), _t(b), tw)
        _rel(got, want)


def test_weighted_tv_and_gram_match_jax():
    a, _ = _pair(2)
    w = np.random.default_rng(3).random(a.shape).astype(np.float32)
    _rel(TL.WeightedTVLoss(0.5)(_t(a), _t(w)),
         JL.WeightedTVLoss(0.5)(jnp.asarray(a), jnp.asarray(w)))
    _close_scaled(TL.gram_matrix(_t(a)), JL.gram_matrix(jnp.asarray(a)),
                  1e-6)


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan",
                                      "wgan_softplus", "hinge"])
def test_gan_loss_matches_jax(gan_type):
    x = np.random.default_rng(4).standard_normal((6, 1)).astype(np.float32)
    x = np.abs(x) + 0.5  # a mean away from 0, where a relative bound means
    #                      something for the linear losses
    j = JL.GANLoss(gan_type, loss_weight=0.1)
    t = TL.GANLoss(gan_type, loss_weight=0.1)
    for real in (True, False):
        for disc in (True, False):
            _rel(t(_t(x), real, disc), j(jnp.asarray(x), real, disc))
    ms = [[_t(x)], _t(x * 2)]
    _rel(TL.MultiScaleGANLoss(gan_type)(ms, True),
         JL.MultiScaleGANLoss(gan_type)([[jnp.asarray(x)],
                                         jnp.asarray(x * 2)], True))


def test_gan_feat_loss_matches_jax():
    rng = np.random.default_rng(5)
    fake = [[rng.random((2, 4, 4, 3)).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    real = [[rng.random((2, 4, 4, 3)).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    for crit in ("l1", "l2", "charbonnier"):
        want = JL.GANFeatLoss(crit, 0.3)(
            [[jnp.asarray(f) for f in fs] for fs in fake],
            [[jnp.asarray(f) for f in fs] for fs in real])
        got = TL.GANFeatLoss(crit, 0.3)(
            [[_t(f) for f in fs] for fs in fake],
            [[_t(f) for f in fs] for fs in real])
        _rel(got, want)


# ---------------------------------------------------------- VGG + loss


@pytest.fixture(scope="module")
def perceptual():
    opt = dict(layer_weights=LAYERS, vgg_type="vgg19", use_input_norm=True,
               range_norm=True, perceptual_weight=1.0, style_weight=50.0,
               criterion="l1")
    jloss = JL.PerceptualLoss(**opt)
    params = _perturb(jloss.vgg_variables["params"], 6, 0.01)
    jloss.vgg_variables = {"params": params}
    tloss = build_loss(dict(type="PerceptualLoss", **opt))
    tloss.vgg.load_state_dict(vgg_state_dict_from_jax(tloss.vgg, params))
    return jloss, tloss


def test_vgg19_forward_matches_flax(perceptual):
    jloss, tloss = perceptual
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    want = jloss.vgg.apply(jloss.vgg_variables, jnp.asarray(x))
    with torch.no_grad():
        got = tloss.vgg(_t(x))
    assert set(got) == set(want) == set(LAYERS)
    for k in LAYERS:
        _close_scaled(got[k], want[k], 1e-5)


def test_perceptual_loss_and_grad_match_jax(perceptual):
    jloss, tloss = perceptual
    x, gt = _pair(8, (2, 32, 32, 3))

    def jfn(xx):
        p, s = jloss(xx, jnp.asarray(gt))
        return p + s, (p, s)

    (_, (jp, js)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(x))
    xt = _t(x, grad=True)
    tp, ts = tloss(xt, _t(gt))
    (tp + ts).backward()
    _rel(tp, jp)
    _rel(ts, js)
    _close_scaled(xt.grad, jg, 1e-4)


def test_vgg_weights_path_loads_a_torchvision_state_dict(tmp_path):
    """A torchvision-layout vgg19 `.pth` (features.N and classifier keys):
    the port loads it with load_state_dict and agrees with the JAX
    importer's load of the same file."""
    from image_restoration_tpu.archs.vgg_arch import VGGFeatureExtractor
    from image_restoration_tpu.convert.vgg_import import \
        load_torchvision_vgg19
    full = build_network(dict(type="VGGFeatureExtractor",
                              layer_name_list=("conv5_4",)))
    rng = np.random.default_rng(9)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32) * 0.05) for k, v in full.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    path = str(tmp_path / "vgg19.pth")
    torch.save(sd, path)
    tl = TL.PerceptualLoss({"conv3_4": 1.0}, vgg_weights_path=path)
    for k, v in tl.vgg.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jnet = VGGFeatureExtractor(layer_name_list=("conv3_4",))
    x = np.random.default_rng(10).random((1, 16, 16, 3)).astype(np.float32)
    jvars = load_torchvision_vgg19(path, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jnet.apply(jvars, jnp.asarray(x))["conv3_4"]
    with torch.no_grad():
        _close_scaled(tl.vgg(_t(x))["conv3_4"], want, 1e-5)


# ------------------------------------------------------ discriminator


@pytest.fixture(scope="module")
def disc():
    x = np.random.default_rng(11).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    jnet = jax_build(TINY_D)
    template = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturb(template["params"], 12)
    port = build_network(TINY_D)
    port.load_state_dict(state_dict_from_jax(port, params), strict=True)
    return dict(jnet=jnet, params=params, template=template, port=port, x=x)


def test_discriminator_forward_matches_flax(disc):
    apply = jax.jit(disc["jnet"].apply)
    for b in (4, 3, 1):  # stddev groups of 4, 3 and 1
        x = disc["x"][:b]
        want = apply({"params": disc["params"]}, jnp.asarray(x))
        with torch.no_grad():
            got = disc["port"](_t(x))
        assert got.shape == (b, 1)
        _close_scaled(got, want, 1e-5)


def test_discriminator_state_dict_is_the_reference_layout(disc):
    """Reference key names, and the JAX importer, in strict mode, gives back
    the flax tree from the port's state_dict (final_linear.0 in (C, H, W)
    order)."""
    sd = disc["port"].state_dict()
    for key in ("conv_body.0.0.weight", "conv_body.0.1.bias",
                "conv_body.1.conv1.0.weight", "conv_body.1.conv2.1.weight",
                "conv_body.1.conv2.2.bias", "conv_body.1.skip.1.weight",
                "final_conv.0.weight", "final_conv.1.bias",
                "final_linear.0.weight", "final_linear.0.bias",
                "final_linear.1.weight", "final_linear.1.bias"):
        assert key in sd, key
    back = import_network("StyleGAN2Discriminator", disc["jnet"],
                          disc["template"],
                          {k: v.numpy() for k, v in sd.items()})["params"]
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(disc["params"])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_r1_penalty_and_its_d_gradients_match_jax(disc):
    """R1 (a double backward through D, K1's autograd formula, the FIR
    depthwise convs and the stddev's sqrt) and its gradient w.r.t. every D
    parameter, against jax.value_and_grad of JAX's r1_penalty."""
    jnet, x = disc["jnet"], disc["x"]

    def jr1(pd):
        return JL.r1_penalty(lambda im: jnet.apply({"params": pd}, im),
                             jnp.asarray(x))

    want, jgrads = jax.jit(jax.value_and_grad(jr1))(disc["params"])
    port = disc["port"]
    port.zero_grad()
    got = TL.r1_penalty(port, _t(x))
    got.backward()
    _rel(got, want, 1e-5)
    jg = state_dict_from_jax(port, jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    for name, p in port.named_parameters():
        # the last biases do not move ∇_x D (zero a.e.): autograd leaves
        # them without a gradient where JAX gives zeros
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close_scaled(g, jg[name], 1e-4)
    port.zero_grad()


def test_gradient_penalty_and_path_length_match_jax(disc):
    jnet, x = disc["jnet"], disc["x"]
    rng = np.random.default_rng(13)
    fake = rng.uniform(-1, 1, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(14)
    want = jax.jit(lambda r, f, k: JL.gradient_penalty_loss(
        lambda im: jnet.apply({"params": disc["params"]}, im), r, f, k))(
        jnp.asarray(x), jnp.asarray(fake), key)
    alpha = jax.random.uniform(key, (x.shape[0], 1, 1, 1))
    got = TL.gradient_penalty_loss(disc["port"], _t(x), _t(fake),
                                   _t(alpha))
    _rel(got, want, 1e-5)

    w = rng.standard_normal((5, 4 * 4 * 3)).astype(np.float32)
    lat = rng.standard_normal((2, 3, 5)).astype(np.float32)

    def jfake(latents):
        return jnp.tanh(latents.mean(1) @ jnp.asarray(w)).reshape(2, 4, 4, 3)

    def tfake(latents):
        return torch.tanh(latents.mean(1) @ _t(w)).reshape(2, 4, 4, 3)

    nkey = jax.random.PRNGKey(15)
    jp, jm, jpm = JL.g_path_regularize(jfake, jnp.asarray(lat), 0.5, nkey)
    noise = jax.random.normal(nkey, (2, 4, 4, 3))
    tp, tm, tpm = TL.g_path_regularize(tfake, _t(lat), 0.5, _t(noise))
    for g, wv in ((tp, jp), (tm, jm), (tpm, jpm)):
        _rel(g, wv, 1e-5)


def test_path_length_gradient_reaches_the_latents_producer():
    """The path-length penalty differentiates through what made the
    latents, as StyleGAN2Model's style MLP makes them: the gradients with
    respect to the map that produces the latents (a tanh layer) and to
    `fake_fn`'s own weights equal `jax.grad` of JAX's
    `g_path_regularize` at the same weights and noise (1e-5 relative)."""
    rng = np.random.default_rng(16)
    z = rng.standard_normal((2, 5)).astype(np.float32)
    wm = rng.standard_normal((5, 5)).astype(np.float32) * 0.5
    bm = rng.standard_normal(5).astype(np.float32) * 0.1
    wf = rng.standard_normal((5, 4 * 4 * 3)).astype(np.float32) * 0.5
    nkey = jax.random.PRNGKey(17)
    noise = jax.random.normal(nkey, (2, 4, 4, 3))

    def jpenalty(params):
        lat = jnp.tanh(jnp.asarray(z) @ params["wm"] + params["bm"])
        lat = jnp.tile(lat[:, None, :], (1, 3, 1))

        def fake(latents):
            return jnp.tanh(latents.mean(1) @ params["wf"]).reshape(
                2, 4, 4, 3)

        return JL.g_path_regularize(fake, lat, 0.5, nkey)[0]

    jparams = {"wm": jnp.asarray(wm), "bm": jnp.asarray(bm),
               "wf": jnp.asarray(wf)}
    want, jgrads = jax.value_and_grad(jpenalty)(jparams)
    tparams = {k: _t(v, grad=True) for k, v in
               (("wm", wm), ("bm", bm), ("wf", wf))}
    lat = torch.tanh(_t(z) @ tparams["wm"] + tparams["bm"])
    lat = lat[:, None, :].repeat(1, 3, 1)

    def tfake(latents):
        return torch.tanh(latents.mean(1) @ tparams["wf"]).reshape(2, 4, 4, 3)

    got = TL.g_path_regularize(tfake, lat, 0.5, _t(noise))[0]
    got.backward()
    _rel(got, want, 1e-5)
    for k, p in tparams.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, k
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.abs(jgrads[k]).max()))


# ------------------------------------------------- schedules, optimizer


SCHEDULES = [
    dict(scheduler=dict(type="MultiStepLR", milestones=[3, 5, 5],
                        gamma=0.5)),
    dict(scheduler=dict(type="MultiStepRestartLR", milestones=[2, 6, 9],
                        gamma=0.5, restarts=[6], restart_weights=[0.7]),
         warmup_iter=3),
    dict(scheduler=dict(type="CosineAnnealingRestartLR", periods=[4, 6],
                        restart_weights=[1, 0.5], eta_min=1e-5)),
    dict(),
]


@pytest.mark.parametrize("train_opt", SCHEDULES,
                         ids=["multistep", "restart", "cosine", "const"])
def test_build_schedule_matches_jax_at_every_count(train_opt):
    jsched = jax_schedule(train_opt, 2e-3)
    tsched = build_schedule(train_opt, 2e-3)
    for count in range(14):
        _rel(tsched(count), jsched(count))


class _Net(torch.nn.Module):
    """Two subtrees, one of them the decoder `fix_decoder` freezes."""

    def __init__(self, arrays):
        super().__init__()
        self.body = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(_t(v)) for k, v in arrays["body"].items()})
        self.stylegan_decoder = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(_t(v))
             for k, v in arrays["stylegan_decoder"].items()})


OPTIMIZERS = [
    (dict(type="Adam", lr=2e-3), dict(betas=(0.0, 0.99)), None),
    (dict(type="Adam", lr=2e-3), dict(betas=(0.0 ** (16 / 17),
                                             0.99 ** (16 / 17)),
                                      lr_scale=16 / 17), None),
    (dict(type="Adam", lr=1e-3), dict(betas=(0.0, 0.99)),
     "stylegan_decoder"),
    (dict(type="Adam", lr=1e-3, grad_clip=0.5), {}, None),
    (dict(type="AdamW", lr=1e-3, weight_decay=0.1), {}, None),
    (dict(type="SGD", lr=1e-2, momentum=0.9), {}, None),
]


@pytest.mark.parametrize("cfg,kw,frozen", OPTIMIZERS,
                         ids=["adam_g", "adam_d", "fix_decoder", "clip",
                              "adamw", "sgd"])
def test_optimizer_matches_optax(cfg, kw, frozen):
    """Six updates from the same gradients (a milestone after the third):
    the port's parameters against optax's through the JAX package's own
    `make_optimizer`. Under `fix_decoder` the port leaves the decoder
    unchanged and without optimizer state; JAX's `optax.masked` passes the
    raw gradient through as the decoder's update (a fault of the JAX
    package, ROADMAP Queue 3), so only the trained leaves are compared."""
    rng = np.random.default_rng(16)
    arrays = {"body": {"a": rng.standard_normal((3, 4)),
                       "b": rng.standard_normal(5)},
              "stylegan_decoder": {"w": rng.standard_normal((2, 2))}}
    arrays = jax.tree_util.tree_map(lambda a: a.astype(np.float32), arrays)
    train = dict(scheduler=dict(type="MultiStepLR", milestones=[3],
                                gamma=0.5), optim=cfg)
    ns = types.SimpleNamespace(opt={"train": train})
    tx = JaxBase.make_optimizer(ns, "optim", arrays, frozen_prefix=frozen,
                                **kw)
    jstate = tx.init(arrays)
    jparams = arrays
    net = _Net(arrays)
    topt = TrainOptimizer(net, cfg, train, frozen_prefix=frozen, **kw)
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            arrays)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.zero_grad()
        for sub in ("body", "stylegan_decoder"):
            for k, p in getattr(net, sub).items():
                p.grad = _t(grads[sub][k])
        topt.step()
        for sub in ("body",) if frozen else ("body", "stylegan_decoder"):
            for k, p in getattr(net, sub).items():
                want = np.asarray(jparams[sub][k])
                _close_scaled(p, want, 1e-6)
    frozen_p = set(map(id, net.stylegan_decoder.parameters()))
    held = {id(p) for p in topt.opt.state}
    assert (frozen_p & held) == (set() if frozen else frozen_p)
    if frozen:
        np.testing.assert_array_equal(
            net.stylegan_decoder["w"].detach().numpy(),
            arrays["stylegan_decoder"]["w"])


def test_ema_update_matches_jax():
    rng = np.random.default_rng(17)
    a = {"x": rng.standard_normal((4, 3)).astype(np.float32)}
    b = {"x": rng.standard_normal((4, 3)).astype(np.float32)}
    decay = 0.5 ** (32 / 10000)
    want = JaxBase.ema_update(a, b, decay)
    ema = torch.nn.ParameterDict({"x": torch.nn.Parameter(_t(a["x"]))})
    cur = torch.nn.ParameterDict({"x": torch.nn.Parameter(_t(b["x"]))})
    BaseModel.ema_update(ema, cur, decay)
    _close_scaled(ema["x"], want["x"], 1e-6)


@pytest.mark.parametrize("up,down,pad", [(1, 2, (2, 1)), (2, 1, (2, 1)),
                                         (1, 1, (1, 2))])
def test_fir_conv_double_backward_is_one_conv_per_layer(up, down, pad):
    """upfirdn2d's depthwise FIR conv under grad: the same values as
    without grad, its first and second derivatives equal to autograd's own
    through a grouped F.conv2d (float64, ≤1e-12), and a double backward of
    a 16-channel layer in a handful of convs where autograd's takes one
    per channel."""
    from torch.profiler import ProfilerActivity, profile
    from image_restoration_tpu_torch.ops import upfirdn as U
    k = U.make_resample_kernel((1, 3, 3, 1)).double()
    x = torch.randn(1, 9, 11, 16, dtype=torch.float64, generator=torch.
                    Generator().manual_seed(0), requires_grad=True)

    def ours(t):
        return U.upfirdn2d(t, k, up=up, down=down, pad=pad)

    def autograd_own(t):
        with mock.patch.object(U, "_FIRConv", _GroupedConv):
            return ours(t)

    with torch.no_grad():
        assert torch.equal(ours(x), autograd_own(x))
    grads = []
    for fn in (ours, autograd_own):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            (g,) = torch.autograd.grad((fn(x) ** 2).sum(), x,
                                       create_graph=True)
            (gg,) = torch.autograd.grad((g ** 2).sum(), x)
        convs = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::convolution")
        grads.append((g, gg, convs))
    for a, b in zip(grads[0][:2], grads[1][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert grads[0][2] <= 6 and grads[1][2] >= 16, (grads[0][2],
                                                    grads[1][2])


class _GroupedConv:
    """autograd's own grouped conv in `_FIRConv`'s place."""

    @staticmethod
    def apply(x, w, stride):
        import torch.nn.functional as F
        return F.conv2d(x, w, stride=stride, groups=x.shape[1])
