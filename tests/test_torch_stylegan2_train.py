"""The port's StyleGAN2 family against the JAX package on the CPU.

At the tiny overrides of `tests/test_option_zoo.py:309-323` (G and D at
32², num_style_feat 16, two MLP layers, channel multiplier 0.25, R1 and the
path-length step every 2 iterations), with both networks at narrow 1/8:
at 32² the channel multiplier reaches no layer, so every layer would
otherwise have 512 channels and this file would take minutes on one
thread. Weights are JAX's flax init plus noise, carried by
`convert/from_jax.py`; inputs are numpy arrays from a seed.

  * the generator with one and two styles (explicit and default
    `inject_index`), truncation and `mean_latent` against flax (1e-5 of
    max|ref|); `StyleGAN2Generator` built from `out_size`, its state dict
    through JAX's `import_network`; `FFHQDataset`;
  * one D+G step's, one R1 step's and one path-length step's losses and
    gradients against `jax.value_and_grad` of JAX's terms at mixing_prob
    0 and batch 4, where JAX and the port agree (losses ≤1e-5 relative,
    gradients ≤1e-4 of max|grad|, at most 1 element in 10⁴ up to 1e-3:
    a pre-activation at the LeakyReLU kink takes the other slope), and the
    running `mean_path_length` (1e-5);
  * the mixed step's latents against JAX's `_prepare` with two styles at
    the same index, the coin's and the index's draws, the path batch;
  * `train_pipeline` on `train_StyleGAN2_256_Cmul2_FFHQ.yml` with
    `device="cpu"`, a resume, and the EMA G sampled from `net_g_{iter}.pth`.
"""

import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build_network
from image_restoration_tpu.convert.torch_import import import_network
from image_restoration_tpu.losses.losses import (g_path_regularize,
                                                 r1_penalty)
from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.archs.stylegan2_arch import \
    StyleGAN2Generator
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.convert.pth import load_pth
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.train import train_pipeline
from image_restoration_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs

CONFIG = "configs/options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml"
NARROW = 0.125
TINY_G = dict(type="StyleGAN2Generator", out_size=32, num_style_feat=16,
              num_mlp=2, channel_multiplier=0.25, resample_kernel=[1, 3, 3, 1],
              lr_mlp=0.01, narrow=NARROW)
TINY_D = dict(type="StyleGAN2Discriminator", out_size=32,
              channel_multiplier=0.25, resample_kernel=[1, 3, 3, 1],
              narrow=NARROW)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(tmp, **train):
    t = {"optim_g": {"type": "Adam", "lr": 0.002},
         "optim_d": {"type": "Adam", "lr": 0.002},
         "scheduler": {"type": "MultiStepLR", "milestones": [600000],
                       "gamma": 0.5},
         "total_iter": 4,
         "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                     "loss_weight": 1.0},
         "r1_reg_weight": 10, "path_batch_shrink": 2, "path_reg_weight": 2,
         "net_g_reg_every": 2, "net_d_reg_every": 2, "mixing_prob": 0.0}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "path": {"models": str(tmp / "models")},
            "logger": {"print_freq": 1}, "model_type": "StyleGAN2Model",
            "network_g": dict(TINY_G), "network_d": dict(TINY_D),
            "train": t}


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX and the port StyleGAN2Model at the same (perturbed) flax
    weights, a real batch of 4, codes, StyleConv noise and the path
    step's image noise."""
    tmp = tmp_path_factory.mktemp("stylegan2")
    opt = _opt(tmp)
    jm = jax_build_model(copy.deepcopy(opt))
    port = build_model(opt, device="cpu")
    pg = _perturb(jm.state["params_g"], 1)
    pd = _perturb(jm.state["params_d"], 2)
    sd_g = state_dict_from_jax(port.net_g, pg)
    port.net_g.load_state_dict(sd_g)
    port.net_g_ema.load_state_dict(sd_g)
    port.net_d.load_state_dict(state_dict_from_jax(port.net_d, pd))
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    z = [rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2)]
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in port.net_g.noise_shapes()]
    return dict(jm=jm, port=port, pg=pg, pd=pd, real=real, z=z, noise=noise)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


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


# ------------------------------------------------------------- generator


@pytest.mark.parametrize("case", ["one", "two_index_3", "two_default",
                                  "truncation"])
def test_generator_matches_flax(pair, case):
    """The forward (image and latents) with one style, two styles at an
    explicit and at the default inject_index, and truncation 0.7 around a
    given latent, against flax at the same weights and noise."""
    jm, port = pair["jm"], pair["port"]
    z = pair["z"]
    kw = {}
    styles = [z[0]] if case in ("one", "truncation") else z[:2]
    if case == "two_index_3":
        kw["inject_index"] = 3
    if case == "truncation":
        kw["truncation"] = 0.7
        kw["truncation_latent"] = np.random.default_rng(4).standard_normal(
            (1, 16)).astype(np.float32)
    want, want_lat = jm.net_g.apply(
        {"params": pair["pg"]}, [jnp.asarray(s) for s in styles],
        noise=[jnp.asarray(n) for n in pair["noise"]], return_latents=True,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    with torch.no_grad():
        got, got_lat = port.net_g(
            [_t(s) for s in styles], noise=[_t(n) for n in pair["noise"]],
            return_latents=True,
            **{k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
    for g, w in ((got, want), (got_lat, want_lat)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_mean_latent_matches_style_forward(pair):
    """`mean_latent(n, generator)`: the mean style-MLP output of n codes
    drawn from the generator, held against flax's style_forward on the
    same codes."""
    port, jm = pair["port"], pair["jm"]
    got = port.net_g.mean_latent(64, torch.Generator().manual_seed(5))
    codes = torch.randn((64, 16), generator=torch.Generator().manual_seed(5))
    want = jnp.mean(jm.net_g.apply({"params": pair["pg"]},
                                   jnp.asarray(codes.numpy()),
                                   method=jm.net_g.style_forward),
                    axis=0, keepdims=True)
    assert got.shape == (1, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * float(jnp.abs(want).max()))


def test_mixed_latents_match_jax_prepare(pair, tmp_path):
    """The mixed step's latents: two styles at the index the model draws,
    against JAX's `_prepare` with two styles at the same index."""
    port, jm = pair["port"], pair["jm"]
    mixer = build_model(_opt(tmp_path, mixing_prob=1.0), device="cpu")
    mixer.net_g.load_state_dict(port.net_g.state_dict())
    codes, index = mixer.mixing_noise(4)
    assert len(codes) == 2 and 1 <= index <= mixer.net_g.num_latent - 1
    with torch.no_grad():
        got = mixer.net_g.latent_codes(codes, inject_index=index)
    want, _ = jm.net_g.apply(
        {"params": pair["pg"]}, [jnp.asarray(c.numpy()) for c in codes],
        False, 1.0, None, index, None, False, method=jm.net_g._prepare)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(jnp.abs(want).max()))


def test_mixing_draws_and_path_batch(tmp_path):
    """The coin falls with probability mixing_prob (0.9 of 2000 draws within
    0.03), the index is uniform over [1, num_latent − 1], the draws are
    counted by part, and the path batch is max(1, batch // shrink)."""
    model = build_model(_opt(tmp_path, mixing_prob=0.9), device="cpu")
    n_lat = model.net_g.num_latent
    mixed, idx = 0, []
    for _ in range(2000):
        codes, index = model.mixing_noise(2, part="d")
        assert all(c.shape == (2, 16) for c in codes)
        if len(codes) == 2:
            mixed += 1
            idx.append(index)
        else:
            assert index is None
    assert abs(mixed / 2000 - 0.9) < 0.03
    assert set(idx) == set(range(1, n_lat))
    assert model.style_draws == {("d", 2): mixed, ("d", 1): 2000 - mixed}
    assert [model.path_batch(b) for b in (1, 2, 3, 4, 24)] == \
        [1, 1, 1, 2, 12]


def test_stylegan2_generator_from_out_size_and_import_network():
    """`build_network(type=StyleGAN2Generator, out_size=...)` builds the
    square generator (also when constructed directly); its reference-layout
    state dict loads with `load_state_dict` and goes through JAX's
    `import_network`, `state_dict_from_jax` brings it back unchanged, and
    flax at the imported weights gives the port's image.

    JAX's importer fits a tensor by shape, so a square linear (every style
    MLP layer, num_style_feat²) keeps the reference's (out, in) where flax
    holds (in, out): it comes back transposed (ROADMAP Queue 3). The
    round trip is held with those layers handed over as (in, out)."""
    net = build_network(dict(TINY_G), torch.Generator().manual_seed(6))
    assert type(net) is StyleGAN2Generator
    assert (net.input_width, net.input_height) == (32, 32)
    direct = StyleGAN2Generator(out_size=32, num_style_feat=16, num_mlp=2,
                                channel_multiplier=0.25, narrow=NARROW)
    sd = net.state_dict()
    direct.load_state_dict(sd, strict=True)
    jnet = jax_build_network(dict(TINY_G))
    variables = jax.jit(lambda k: jnet.init(k, [jnp.zeros((1, 16))]))(
        jax.random.PRNGKey(0))
    square = {k for k, v in sd.items()
              if v.dim() == 2 and v.shape[0] == v.shape[1]}
    assert {k for k in square if k.startswith("style_mlp.")} == {
        "style_mlp.1.weight", "style_mlp.2.weight"}
    raw = state_dict_from_jax(net, import_network(
        "StyleGAN2Generator", jnet, variables,
        {k: v.numpy() for k, v in sd.items()})["params"])
    for k in square:
        torch.testing.assert_close(raw[k], sd[k].T, rtol=0, atol=0)
    params = import_network("StyleGAN2Generator", jnet, variables, {
        k: v.numpy().T if k in square else v.numpy()
        for k, v in sd.items()})["params"]
    back = state_dict_from_jax(net, params)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    z = np.random.default_rng(7).standard_normal((2, 16)).astype(np.float32)
    want = jnet.apply({"params": params}, [jnp.asarray(z)],
                      randomize_noise=False)[0]
    with torch.no_grad():
        got = net([_t(z)], randomize_noise=False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(jnp.abs(want).max()))


def test_ffhq_dataset(tmp_path):
    """FFHQDataset: GT only, the flip from Python's `random`, BGR → RGB,
    (x − mean)/std; an lmdb of the image gives the same item."""
    import random
    os.makedirs(tmp_path / "gt")
    img = (np.random.default_rng(8).random((16, 12, 3)) * 255).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "gt" / "a.png"), img)
    opt = dict(type="FFHQDataset", name="FFHQ",
               dataroot_gt=str(tmp_path / "gt"),
               io_backend={"type": "disk"}, use_hflip=True,
               mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5])
    ds = build_dataset(opt)
    assert len(ds) == 1
    rgb = img[..., ::-1].astype(np.float32) / 255.0
    seen = set()
    for seed in range(8):
        random.seed(seed)
        flip = random.random() < 0.5
        random.seed(seed)
        item = ds[0]
        want = (rgb[:, ::-1] if flip else rgb) * 2 - 1
        assert set(item) == {"gt", "gt_path"}
        assert item["gt"].dtype == np.float32
        np.testing.assert_allclose(item["gt"], want, atol=1e-6)
        seen.add(flip)
    assert seen == {True, False}
    make_lmdb_from_imgs(str(tmp_path / "gt"), str(tmp_path / "gt.lmdb"),
                        ["a.png"], ["a"])
    db = build_dataset(dict(opt, dataroot_gt=str(tmp_path / "gt.lmdb"),
                            io_backend={"type": "lmdb"}))
    assert db.paths == ["a"]
    for seed in range(2):
        random.seed(seed)
        want = ds[0]["gt"]
        random.seed(seed)
        np.testing.assert_array_equal(db[0]["gt"], want)


# ------------------------------------------------------------- the steps


def _jax_d_loss(jm, pg, pd, z, noise, real):
    fake = jm.net_g.apply({"params": pg}, [z], noise=noise)[0]
    fake_pred = jm.net_d.apply({"params": pd}, jax.lax.stop_gradient(fake))
    real_pred = jm.net_d.apply({"params": pd}, real)
    l_d = jm.cri_gan(real_pred, True, is_disc=True) + \
        jm.cri_gan(fake_pred, False, is_disc=True)
    return l_d, (jnp.mean(real_pred), jnp.mean(fake_pred))


def test_d_step_matches_jax(pair):
    jm, port = pair["jm"], pair["port"]
    z, noise = jnp.asarray(pair["z"][0]), [jnp.asarray(n)
                                            for n in pair["noise"]]
    (jl, (jr, jf)), jgrads = jax.jit(jax.value_and_grad(
        lambda pd: _jax_d_loss(jm, pair["pg"], pd, z, noise,
                               jnp.asarray(pair["real"])),
        has_aux=True))(pair["pd"])
    port.net_d.zero_grad()
    with torch.no_grad():
        fake = port.g_forward([_t(pair["z"][0])], None,
                              [_t(n) for n in pair["noise"]])
    l_d, rs, fs = port.d_loss(fake, _t(pair["real"]))
    l_d.backward()
    _check_losses({"l_d": l_d, "real_score": rs, "fake_score": fs},
                  {"l_d": jl, "real_score": jr, "fake_score": jf})
    _check_grads(port.net_d, jgrads)
    port.net_d.zero_grad()


def test_g_step_matches_jax(pair):
    jm, port = pair["jm"], pair["port"]
    z, noise = jnp.asarray(pair["z"][1]), [jnp.asarray(n)
                                            for n in pair["noise"]]

    def g_loss(pg):
        fake = jm.net_g.apply({"params": pg}, [z], noise=noise)[0]
        return jm.cri_gan(jm.net_d.apply({"params": pair["pd"]}, fake),
                          True, is_disc=False)

    jl, jgrads = jax.jit(jax.value_and_grad(g_loss))(pair["pg"])
    port.net_g.zero_grad()
    port.net_d.requires_grad_(False)
    l_g = port.g_loss([_t(pair["z"][1])], None,
                      [_t(n) for n in pair["noise"]])
    l_g.backward()
    port.net_d.requires_grad_(True)
    assert all(p.grad is None for p in port.net_d.parameters())
    _check_losses({"l_g": l_g}, {"l_g": jl})
    _check_grads(port.net_g, jgrads)
    port.net_g.zero_grad()


def test_r1_step_matches_jax(pair):
    """R1 weighted r1/2 · net_d_reg_every: a double backward through D."""
    jm, port = pair["jm"], pair["port"]
    weight = jm.r1_reg_weight / 2 * jm.net_d_reg_every
    jl, jgrads = jax.jit(jax.value_and_grad(lambda pd: weight * r1_penalty(
        lambda x: jm.net_d.apply({"params": pd}, x),
        jnp.asarray(pair["real"]))))(pair["pd"])
    port.net_d.zero_grad()
    l_r1 = port.r1_loss(_t(pair["real"]))
    l_r1.backward()
    _check_losses({"l_d_r1": l_r1}, {"l_d_r1": jl})
    _check_grads(port.net_d, jgrads)
    port.net_d.zero_grad()


def test_path_step_matches_jax(pair):
    """The path-length step as JAX's `g_reg` builds it (codes through the
    style MLP, tiled, the penalty through `fake_fn`), at the path batch
    max(1, 4 // 2) = 2 on which JAX and the port agree: the weighted
    penalty, the G gradients (the style MLP's included) and the running
    mean path length."""
    jm, port = pair["jm"], pair["port"]
    pb = port.path_batch(4)
    assert pb == max(1, jm.opt["train"]["path_batch_shrink"]) == 2
    z = pair["z"][0][:pb]
    noise = [jnp.asarray(n) for n in pair["noise"]]
    kp = jax.random.PRNGKey(9)
    mpl = 0.37

    def loss(pg):
        lat = jm.net_g.apply({"params": pg}, jnp.asarray(z),
                             method=jm.net_g.style_forward)
        lat = jnp.tile(lat[:, None, :], (1, jm.net_g.num_latent, 1))

        def fake_fn(latents):
            return jm.net_g.apply({"params": pg}, [latents],
                                  input_is_latent=True, noise=noise)[0]

        penalty, _, new_mpl = g_path_regularize(fake_fn, lat, mpl, kp)
        return jm.path_reg_weight * jm.net_g_reg_every * penalty, new_mpl

    (jl, jmpl), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        pair["pg"])
    img_noise = _t(jax.random.normal(kp, (pb, 32, 32, 3)))
    port.net_g.zero_grad()
    port.mean_path_length = torch.tensor(mpl)
    l_path, _, new_mpl = port.path_loss([_t(z)], None,
                                        [_t(n) for n in pair["noise"]],
                                        img_noise)
    l_path.backward()
    _check_losses({"l_g_path": l_path, "mean_path_length": new_mpl},
                  {"l_g_path": jl, "mean_path_length": jmpl})
    mlp = [p.grad for n, p in port.net_g.named_parameters()
           if n.startswith("style_mlp.")]
    assert mlp and all(g is not None and float(g.abs().max()) > 0
                       for g in mlp)
    _check_grads(port.net_g, jgrads)
    port.net_g.zero_grad()


def test_optimizers_are_lazy_regularized(pair):
    """lr·r and betas (0^r, 0.99^r), r = k/(k+1), for G (k =
    net_g_reg_every) and D (k = net_d_reg_every); EMA decay
    0.5^(32/10⁴)."""
    port = pair["port"]
    for tx, k in ((port.optimizer_g, port.net_g_reg_every),
                  (port.optimizer_d, port.net_d_reg_every)):
        r = k / (k + 1)
        group = tx.opt.param_groups[0]
        assert group["betas"] == (0.0, 0.99 ** r)
        assert tx.schedule(0) == pytest.approx(0.002 * r, rel=1e-12)
    assert port.ema_decay == 0.5 ** (32 / 10000)


def test_step_runs_every_part_and_counts_its_draws(tmp_path):
    """Iteration 2 (R1 and the path step both due at every 2) with
    mixing_prob 1: D, G, R1 and the path-length step each update their
    network, `mean_path_length` moves off 0, every draw is mixed, and the
    losses stay on the device, detached."""
    model = build_model(_opt(tmp_path, mixing_prob=1.0), device="cpu")
    real = np.random.default_rng(10).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    g0 = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.optimize_parameters(1, {"gt": real})
    assert model.optimizer_g.count == 1 and model.optimizer_d.count == 1
    losses = model.optimize_parameters(2, {"gt": real})
    assert set(losses) == {"l_g", "l_d", "real_score", "fake_score",
                           "l_d_r1", "l_g_path", "path_length"}
    assert all(torch.is_tensor(v) and not v.requires_grad
               for v in losses.values())
    assert all(np.isfinite(v) for v in model.log_dict.values())
    assert model.optimizer_g.count == 3 and model.optimizer_d.count == 3
    assert float(model.mean_path_length) > 0
    assert model.style_draws == {("d", 2): 2, ("g", 2): 2, ("path", 2): 1}
    assert any(not torch.equal(v, g0[k])
               for k, v in model.net_g.state_dict().items()
               if k.startswith("style_mlp."))


# ----------------------------------------------------------- train_pipeline


def test_train_pipeline_resume_and_sample(tmp_path):
    """`train_pipeline` on the StyleGAN2 config at the tiny overrides (disk
    backend, 2 iterations with R1 and the path step at 2), a resume that
    restores every piece of state, 2 more iterations through
    --auto_resume, then `net_g_4.pth`'s EMA G loaded into a fresh
    StyleGAN2Generator samples at truncation 0.7 around its mean latent
    what the trained EMA G samples on the same codes."""
    os.makedirs(tmp_path / "gt")
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(tmp_path / "gt" / f"{i:05d}.png"),
                    (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    g_over = [f"network_g:{k}={v}" for k, v in TINY_G.items()
              if k != "type"]
    d_over = [f"network_d:{k}={v}" for k, v in TINY_D.items()
              if k != "type"]
    argv = ["-opt", os.path.join(REPO, CONFIG), "--force_yml",
            f"datasets:train:dataroot_gt={tmp_path / 'gt'}",
            "datasets:train:io_backend={type: disk}",
            "train:net_d_reg_every=2", "train:net_g_reg_every=2",
            "train:total_iter=2", "logger:print_freq=1",
            "logger:save_checkpoint_freq=2", "logger:use_tb_logger=false",
            *g_over, *d_over]
    model = train_pipeline(str(tmp_path), argv=argv, device="cpu")
    assert model.iter == 2 and model.optimizer_g.count == 3
    assert {"l_d_r1", "l_g_path"} <= set(model.log_dict)
    assert all(np.isfinite(v) for v in model.log_dict.values())
    mdir = model.opt["path"]["models"]
    assert os.path.exists(os.path.join(mdir, "ckpt_2.pth"))

    again = build_model(model.opt, device="cpu")
    again.resume(os.path.join(mdir, "ckpt_2.pth"))
    for a, b in ((again.net_g, model.net_g), (again.net_d, model.net_d),
                 (again.net_g_ema, model.net_g_ema)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert again.iter == 2 and again.optimizer_d.count == 3
    assert torch.equal(again.mean_path_length, model.mean_path_length)

    resumed = train_pipeline(str(tmp_path), argv=[
        *argv, "train:total_iter=4", "--auto_resume"], device="cpu")
    assert resumed.iter == 4 and resumed.optimizer_g.count == 6
    pth = os.path.join(mdir, "net_g_4.pth")
    fresh = StyleGAN2Generator(**{k: v for k, v in TINY_G.items()
                                  if k != "type"})
    fresh.load_state_dict(load_pth(pth, "params_ema"), strict=True)
    fresh.eval()
    codes = [torch.randn((8, 16), generator=torch.Generator().manual_seed(11))]
    with torch.no_grad():
        mean = fresh.mean_latent(4096, torch.Generator().manual_seed(12))
        got = fresh(codes, truncation=0.7, truncation_latent=mean,
                    randomize_noise=False)[0]
    want_mean = resumed.net_g_ema.mean_latent(
        4096, torch.Generator().manual_seed(12))
    with torch.no_grad():
        want = resumed.net_g_ema(codes, truncation=0.7,
                                 truncation_latent=want_mean,
                                 randomize_noise=False)[0]
    assert got.shape == (8, 32, 32, 3) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_trainer_registered_and_defaults_to_cuda(tmp_path, monkeypatch):
    """`model_type: StyleGAN2Model` builds the port's trainer; unset, its
    device is cuda, so without a GPU it raises rather than train on the
    CPU."""
    from image_restoration_tpu_torch.models.stylegan2_model import \
        StyleGAN2Model
    assert type(build_model(_opt(tmp_path), device="cpu")) is StyleGAN2Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_opt(tmp_path))
