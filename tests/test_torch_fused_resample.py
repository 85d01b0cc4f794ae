"""The port's fused FIR-resample convs (`ops/fused_resample.py`) against
the JAX package on the CPU.

`conv_up_fir` and `conv_down_fir` against JAX's fused functions and
against the port's own two-pass path (transposed conv + FIR smooth, FIR
smooth + strided conv) at `tests/test_fused_resample.py`'s shapes (atol
2e-5, rtol 1e-5; weights OIHW here, HWIO in JAX); the `FUSE_UP` /
`FUSE_DOWN` switches (environment at import, attributes at call time) in
the modulated conv and `ConvLayer`; a tiny GFPGANv1OCR forward with both
flags on against JAX's with both on (1e-4 absolute, as JAX's own flag test),
and `Restorer(quant="dyn-int8")` with both on against JAX's with both on
at `tests/test_torch_dyn_int8.py`'s gate; a float64 gradcheck of each
fused op.
"""

import importlib
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu.ops import fused_resample as jfr
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.archs.stylegan2_arch import ConvLayer
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.ops import fused_resample as tfr
from image_restoration_tpu_torch.ops import modulated_conv as tmc
from image_restoration_tpu_torch.ops.modulated_conv import (conv2d,
                                                            conv_transpose2d)
from image_restoration_tpu_torch.ops.upfirdn import upfirdn_smooth

FIR = (1, 3, 3, 1)
TINY_GFPGAN = dict(type="GFPGANv1OCR", input_width=64, input_height=64,
                   num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
                   input_is_latent=True, different_w=True, narrow=0.5,
                   sft_half=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextmanager
def fused(up=True, down=True):
    """Both packages' flags set for the block, restored after."""
    saved = [(m, m.FUSE_UP, m.FUSE_DOWN) for m in (jfr, tfr)]
    try:
        for m in (jfr, tfr):
            m.FUSE_UP, m.FUSE_DOWN = up, down
        yield
    finally:
        for m, u, d in saved:
            m.FUSE_UP, m.FUSE_DOWN = u, d


def _xw(seed, n, h, w, ci, co, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, ci, co)).astype(np.float32)
    return x, w_hwio, torch.from_numpy(
        np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,w,ci,co", [(16, 16, 8, 12), (17, 23, 4, 4),
                                       (8, 8, 3, 5)])
def test_conv_up_fir_matches_jax_and_two_pass(h, w, ci, co):
    x, w_hwio, wt = _xw(0, 2, h, w, ci, co, 3)
    xt = torch.from_numpy(x)
    got = tfr.conv_up_fir(xt, wt, FIR).numpy()
    two_pass = upfirdn_smooth(conv_transpose2d(xt, wt, 2), FIR,
                              upsample_factor=2, kernel_size=3).numpy()
    want = np.asarray(jfr.conv_up_fir(jnp.asarray(x), jnp.asarray(w_hwio),
                                      FIR))
    assert got.shape == two_pass.shape == want.shape == (2, 2 * h, 2 * w, co)
    np.testing.assert_allclose(got, two_pass, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,ci,co,k", [(16, 16, 8, 12, 3),
                                         (32, 48, 4, 4, 3),
                                         (16, 16, 8, 12, 1),
                                         (18, 22, 5, 7, 1)])
def test_conv_down_fir_matches_jax_and_two_pass(h, w, ci, co, k):
    x, w_hwio, wt = _xw(1, 2, h, w, ci, co, k)
    xt = torch.from_numpy(x)
    got = tfr.conv_down_fir(xt, wt, FIR).numpy()
    two_pass = conv2d(upfirdn_smooth(xt, FIR, downsample_factor=2,
                                     kernel_size=k), wt, stride=2,
                      padding=0).numpy()
    want = np.asarray(jfr.conv_down_fir(jnp.asarray(x),
                                        jnp.asarray(w_hwio), FIR))
    assert got.shape == two_pass.shape == want.shape
    np.testing.assert_allclose(got, two_pass, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("op,shape", [("up", (1, 5, 6, 3, 2, 3)),
                                      ("down", (1, 9, 8, 2, 3, 3))])
def test_fused_ops_gradcheck(op, shape):
    """Both fused ops are differentiable in x and the weight (float64)."""
    n, h, w, ci, co, k = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn((n, h, w, ci), generator=g, dtype=torch.float64,
                    requires_grad=True)
    wt = torch.randn((co, ci, k, k), generator=g, dtype=torch.float64,
                     requires_grad=True)
    fn = tfr.conv_up_fir if op == "up" else tfr.conv_down_fir
    assert torch.autograd.gradcheck(lambda a, b: fn(a, b, FIR), (x, wt))


def test_flags_read_from_the_environment(monkeypatch):
    """`IRT_FUSE_UP` / `IRT_FUSE_DOWN` set the attributes at import; unset,
    both are off, as in JAX."""
    seen = []
    try:
        for env in ({}, {"IRT_FUSE_UP": "1"}, {"IRT_FUSE_DOWN": "1"}):
            monkeypatch.delenv("IRT_FUSE_UP", raising=False)
            monkeypatch.delenv("IRT_FUSE_DOWN", raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            importlib.reload(tfr)
            seen.append((tfr.FUSE_UP, tfr.FUSE_DOWN))
    finally:
        monkeypatch.undo()
        importlib.reload(tfr)
    assert seen == [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("mode", ["upsample", "downsample"])
def test_modulated_conv_switches_to_the_fused_op(mode):
    """With its flag on, `modulated_conv2d` runs the fused op with
    `fused_valid_conv` as its inner conv, and gives the two-pass result."""
    x, _, wt = _xw(3, 2, 8, 8, 4, 6, 3)
    xt = torch.from_numpy(x)
    style = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, (2, 4)).astype(np.float32))
    want = tmc.modulated_conv2d(xt, wt, style, sample_mode=mode)
    name = "conv_up_fir" if mode == "upsample" else "conv_down_fir"
    real = getattr(tmc, name)
    with fused(), mock.patch.object(tmc, name, wraps=real) as spy:
        got = tmc.modulated_conv2d(xt, wt, style, sample_mode=mode)
    assert spy.call_count == 1
    assert spy.call_args.kwargs["conv_fn"] is tmc.fused_valid_conv
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("k,activate", [(3, True), (1, False)])
def test_convlayer_fuse_down_keeps_its_keys(k, activate):
    """A downsampling ConvLayer under FUSE_DOWN takes the fused path on its
    own parameters (the reference keys unchanged) and gives the two-pass
    result; a layer that does not downsample is untouched."""
    g = torch.Generator().manual_seed(5)
    layer = ConvLayer(4, 6, k, downsample=True, bias=True, activate=activate)
    for p in layer.parameters():
        p.data.normal_(generator=g)
    keys = sorted(layer.state_dict())
    x = torch.randn((2, 12, 10, 4), generator=g)
    want = layer(x)
    with fused(), mock.patch("image_restoration_tpu_torch.archs."
                             "stylegan2_arch.conv_down_fir",
                             wraps=tfr.conv_down_fir) as spy:
        got = layer(x)
        plain = ConvLayer(4, 6, 3)
        plain(torch.zeros((1, 6, 6, 4)))
    assert spy.call_count == 1
    assert sorted(layer.state_dict()) == keys
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=2e-5, rtol=1e-5)


def _jax_params(jnet, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jnet.variables["params"])


def test_gfpgan_forward_flags_on_matches_jax():
    """TINY_GFPGAN (64²) with FUSE_UP and FUSE_DOWN on: the port's forward
    against JAX's forward with both on, and against its own with both
    off, at the same weights (1e-4)."""
    jr = JaxRestorer(TINY_GFPGAN)
    params = _jax_params(jr, 6)
    net = build_network(TINY_GFPGAN).eval()
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        off = net(torch.from_numpy(x), randomize_noise=False)[0].numpy()
        with fused():
            on = net(torch.from_numpy(x), randomize_noise=False)[0].numpy()
            want = np.asarray(jax.jit(lambda p, v: jr.net.apply(
                {"params": p}, v, randomize_noise=False)[0])(
                    params, jnp.asarray(x)))
    np.testing.assert_allclose(on, want, atol=1e-4)
    np.testing.assert_allclose(on, off, atol=1e-4)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_restorer_dyn_int8_flags_on_matches_jax(capsys):
    """`Restorer(quant="dyn-int8")` with both flags on (the fused convs
    quantized through `fused_valid_conv`) against JAX's with both on:
    port vs JAX closer than JAX's dyn-int8 to JAX's float32, the gate of
    tests/test_torch_dyn_int8.py."""
    imgs = np.random.default_rng(8).random((4, 64, 64, 3)).astype(
        np.float32)
    with fused():
        jf = JaxRestorer(TINY_GFPGAN)
        params = _jax_params(jf, 9)
        jf.variables = {"params": params}
        jq = JaxRestorer(TINY_GFPGAN, quant="dyn-int8")
        jq.variables = jf.variables
        tq = Restorer(TINY_GFPGAN, quant="dyn-int8", device="cpu")
        tq.net.load_state_dict(state_dict_from_jax(tq.net, params))
        j_f32, j_int8 = jf.restore_batch(imgs), jq.restore_batch(imgs)
        t_int8 = tq.restore_batch(imgs)
    port_vs_jax, jax_int8_vs_f32 = _psnr(t_int8, j_int8), _psnr(j_int8,
                                                                j_f32)
    with capsys.disabled():
        print(f"\ndyn-int8 with FUSE_UP and FUSE_DOWN, TINY_GFPGAN 64²: port "
              f"vs JAX {port_vs_jax:.2f} dB, JAX dyn-int8 vs JAX f32 "
              f"{jax_int8_vs_f32:.2f} dB")
    assert port_vs_jax > jax_int8_vs_f32
