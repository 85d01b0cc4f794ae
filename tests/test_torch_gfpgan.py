"""Port StyleGAN2 blocks and GFPGANv1OCR against the JAX package at the same
weights and inputs: flax params (perturbed so that zero-initialised biases
and noise strengths are exercised) go through `state_dict_from_jax`; inputs
and noise are numpy arrays from a seed. f32, atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.archs import stylegan2_arch as jsg
from image_restoration_tpu.archs import gfpgan_ocr_arch as jgf
from image_restoration_tpu.convert.torch_import import import_network
from image_restoration_tpu.infer import PRODUCTION_GFPGAN
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.archs import stylegan2_arch as tsg
from image_restoration_tpu_torch.archs import gfpgan_ocr_arch as tgf
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.ops import modulated_conv as tmc


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_GFPGAN = dict(type="GFPGANv1OCR", input_width=64, input_height=64,
                   num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
                   input_is_latent=True, different_w=True, narrow=0.5,
                   sft_half=True)
ATOL = 1e-4


def _perturb(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(port, params), strict=True)
    return port.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 64, 64, 3)) * 0.5).astype(np.float32)
    jnet = jax_build(TINY_GFPGAN)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturb(variables["params"], rng)
    port = _load(build_network(TINY_GFPGAN), params)
    return dict(jnet=jnet, template=variables, params=params, port=port, x=x,
                rng=rng)


def test_gfpgan_tiny_matches_jax(tiny):
    want, want_rgbs = jax.jit(tiny["jnet"].apply)({"params": tiny["params"]},
                                                  jnp.asarray(tiny["x"]))
    with torch.no_grad():
        got, got_rgbs = tiny["port"](torch.from_numpy(tiny["x"]))
    assert got.shape == want.shape == (2, 64, 64, 3)
    _close(got, want)
    assert len(got_rgbs) == len(want_rgbs) == 4
    for g, w in zip(got_rgbs, want_rgbs):
        assert g.shape == w.shape
        _close(g, w)


def test_gfpgan_tiny_explicit_noise_matches_jax(tiny):
    """Noise arrays handed to both nets (the perturbed noise strengths are
    non-zero, so the noise reaches the output)."""
    rng = np.random.default_rng(11)
    shapes = tiny["port"].stylegan_decoder.noise_shapes()
    noise = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want, _ = tiny["jnet"].apply({"params": tiny["params"]},
                                 jnp.asarray(tiny["x"][:1]),
                                 noise=[jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got, _ = tiny["port"](torch.from_numpy(tiny["x"][:1]),
                              noise=[torch.from_numpy(n) for n in noise],
                              return_rgb=False)
    _close(got, want)
    with torch.no_grad():
        zero, _ = tiny["port"](torch.from_numpy(tiny["x"][:1]))
    assert not torch.allclose(zero, got)


def test_state_dict_roundtrips_through_import_network(tiny):
    """The port's state_dict, fed to the JAX importer in strict mode, gives
    back the flax tree it was made from, exactly."""
    sd = {k: v.numpy() for k, v in tiny["port"].state_dict().items()}
    back = import_network("GFPGANv1OCR", tiny["jnet"], tiny["template"],
                          sd)["params"]
    want = jax.tree_util.tree_leaves_with_path(tiny["params"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_uses_reference_names(tiny):
    sd = tiny["port"].state_dict()
    for key in ("conv_body_first.0.weight", "conv_body_first.1.bias",
                "conv_body_down.0.conv2.1.weight",
                "conv_body_down.0.conv2.2.bias",
                "conv_body_down.0.skip.1.weight",
                "conv_body_up.0.conv2.activation.bias",
                "condition_scale.0.2.bias", "final_linear.weight",
                "stylegan_decoder.style_conv1.activate.bias",
                "stylegan_decoder.style_convs.0.modulated_conv.weight",
                "stylegan_decoder.to_rgbs.0.modulated_conv.modulation.bias",
                "stylegan_decoder.constant_input.weight"):
        assert key in sd, key
    assert sd["stylegan_decoder.style_convs.0.modulated_conv.weight"].dim() == 5
    assert not any("style_mlp" in k or "noises" in k for k in sd)


@pytest.mark.parametrize("mode", [None, "upsample"])
def test_style_conv_matches_jax(rng, mode):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    style = rng.standard_normal((2, 5)).astype(np.float32)
    noise = rng.standard_normal(
        (2, 16 if mode else 8, 16 if mode else 8, 1)).astype(np.float32)
    jm = jsg.StyleConv(10, 3, 5, sample_mode=mode)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(style))
    p = _perturb(v["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style),
                    noise=jnp.asarray(noise))
    port = _load(tsg.StyleConv(6, 10, 3, 5, sample_mode=mode), p)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(style),
                   noise=torch.from_numpy(noise))
    _close(got, want)


def test_to_rgb_matches_jax(rng):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    style = rng.standard_normal((2, 5)).astype(np.float32)
    skip = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jm = jsg.ToRGB(5, upsample=True)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(style))
    p = _perturb(v["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style),
                    jnp.asarray(skip))
    port = _load(tsg.ToRGB(6, 5, upsample=True), p)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(style),
                   torch.from_numpy(skip))
    _close(got, want)


@pytest.mark.parametrize("k,activate,bias", [(3, True, True), (1, False, False),
                                             (3, False, True),
                                             (3, True, False)])
def test_conv_up_layer_matches_jax(rng, k, activate, bias):
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    jm = jgf.ConvUpLayer(7, k, padding=k // 2, use_bias=bias,
                         activate=activate)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    p = _perturb(v["params"], rng)
    want = jm.apply({"params": p}, jnp.asarray(x))
    port = _load(tgf.ConvUpLayer(4, 7, k, padding=k // 2, bias=bias,
                                 activate=activate), p)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 12, 10, 7)
    _close(got, want)


def test_generator_with_style_mlp_matches_jax(rng):
    """The standalone generator fed style codes (not latents) runs its
    style MLP (EqualLinear with the fused activation) before the decoder."""
    cfg = dict(input_width=16, input_height=16, num_style_feat=8, num_mlp=2,
               channel_multiplier=0.25, narrow=0.0625)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    jm = jsg.StyleGAN2OCRGenerator(**cfg)
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in jm.noise_shapes()]
    v = jm.init(jax.random.PRNGKey(4), [jnp.asarray(z)])
    p = _perturb(v["params"], rng)
    want, _ = jm.apply({"params": p}, [jnp.asarray(z)],
                       noise=[jnp.asarray(n) for n in noise])
    port = _load(build_network(dict(type="StyleGAN2OCRGenerator", **cfg)), p)
    with torch.no_grad():
        got, _ = port([torch.from_numpy(z)],
                      noise=[torch.from_numpy(n) for n in noise])
    assert "style_mlp.1.weight" in port.state_dict()
    _close(got, want)


def test_dtype_reaches_the_convs(tiny, monkeypatch):
    """dtype=bf16 must run every conv in bf16 (the JAX package once shipped
    layers that declared dtype and never applied it)."""
    seen = []
    conv, convt = tmc.F.conv2d, tmc.F.conv_transpose2d

    def spy(fn):
        def wrapped(x, w, *a, **k):
            seen.append((x.dtype, w.dtype))
            return fn(x, w, *a, **k)
        return wrapped

    net = build_network(dict(TINY_GFPGAN, dtype="bf16"))
    net.load_state_dict(tiny["port"].state_dict())
    monkeypatch.setattr(tmc.F, "conv2d", spy(conv))
    monkeypatch.setattr(tmc.F, "conv_transpose2d", spy(convt))
    with torch.no_grad():
        out, _ = net(torch.from_numpy(tiny["x"][:1]), return_rgb=False)
    monkeypatch.undo()
    assert out.dtype == torch.bfloat16
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen)
    with torch.no_grad():
        ref, _ = tiny["port"](torch.from_numpy(tiny["x"][:1]),
                              return_rgb=False)
    assert (out.float() - ref).abs().mean() < 0.05


@pytest.mark.slow
def test_gfpgan_production_256_matches_jax():
    """PRODUCTION_GFPGAN at 256², batch 1: image within 1e-4."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 256, 256, 3)) * 0.5).astype(np.float32)
    jnet = jax_build(PRODUCTION_GFPGAN)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturb(variables["params"], rng, scale=0.02)
    want, _ = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    port = _load(build_network(PRODUCTION_GFPGAN), params)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), return_rgb=False)
    _close(got, want)
