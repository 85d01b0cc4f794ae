"""Port kernel K1 (fused bias + LeakyReLU·√2): the plain PyTorch version
against the JAX jnp twin and the Pallas kernel in interpret mode, and the
wrapper's dispatch. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_restoration_tpu.ops.fused_act import (
    fused_leaky_relu as jax_fused_leaky_relu,
    scaled_leaky_relu as jax_scaled_leaky_relu)
from image_restoration_tpu.ops.pallas import fused_bias_lrelu_pallas
from image_restoration_tpu_torch.ops import fused_act
from image_restoration_tpu_torch.ops.fused_act import (
    FusedLeakyReLU, fused_leaky_relu, fused_leaky_relu_plain,
    scaled_leaky_relu)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ragged M (70 rows: not a multiple of block_m=16), narrow and wide C
SHAPES = [(2, 5, 7, 128), (3, 11, 16), (4, 4, 3), (70, 8)]


def _inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    return x, b


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_f32(rng, shape):
    """f32: same arithmetic as the jnp twin, atol 1e-6."""
    x, b = _inputs(rng, shape)
    want = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    got = fused_leaky_relu_plain(torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want_nb = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), None, 0.1, 2.0))
    got_nb = fused_leaky_relu_plain(torch.from_numpy(x), None, 0.1, 2.0)
    np.testing.assert_allclose(got_nb.numpy(), want_nb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 5, 7, 128), (70, 8)])
def test_plain_matches_pallas_interpret(rng, shape):
    """The TPU kernel in interpret mode, ragged M with block_m=16 (as
    tests/test_ops.py does): atol 1e-6."""
    x, b = _inputs(rng, shape)
    want = np.asarray(fused_bias_lrelu_pallas(jnp.asarray(x), jnp.asarray(b),
                                              block_m=16, interpret=True))
    got = fused_leaky_relu_plain(torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_plain_matches_jax_bf16(rng):
    """bf16: the port computes in f32 and rounds once (the kernel's
    arithmetic); the jnp twin rounds after the add and after each multiply.
    The two stay within 2 bf16 ulps: rtol 2**-6."""
    x, b = _inputs(rng, (6, 9, 32))
    xb = jnp.asarray(x, jnp.bfloat16)
    bb = jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jax_fused_leaky_relu(xb, bb).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    bt = torch.from_numpy(np.array(bb.astype(jnp.float32))).bfloat16()
    got = fused_leaky_relu_plain(xt, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6, atol=0)


def test_scaled_leaky_relu_matches_jax(rng):
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    want = np.asarray(jax_scaled_leaky_relu(jnp.asarray(x)))
    got = scaled_leaky_relu(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_cpu_tensor_takes_plain_path(rng, monkeypatch):
    """A CPU tensor never builds or launches the kernel."""
    def no_kernel():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(fused_act, "_kernel_lib", no_kernel)
    before = fused_leaky_relu.launches
    x, b = _inputs(rng, (4, 6, 16))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    got = fused_leaky_relu(xt, bt)
    assert fused_leaky_relu.launches == before
    assert torch.equal(got, fused_leaky_relu_plain(xt, bt))
    want = np.where(x + b >= 0, x + b, (x + b) * 0.2) * math.sqrt(2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    m = FusedLeakyReLU(16)
    with torch.no_grad():
        m.bias.copy_(bt)
    assert torch.equal(m(xt), got)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_leaky_relu(torch.empty((2, 4), device="meta"))


def _away_from_kink(rng, shape):
    """float64 x and bias with every |x + b| ≥ 0.05, so the finite
    differences of gradcheck never straddle the kink at 0."""
    x, b = (a.astype(np.float64) for a in _inputs(rng, shape))
    v = x + b
    x = np.where(np.abs(v) < 0.05, x + np.sign(v + 1e-9) * 0.1, x)
    return (torch.from_numpy(x).requires_grad_(),
            torch.from_numpy(b).requires_grad_())


@pytest.mark.parametrize("shape,with_bias", [((3, 5, 8), True),
                                             ((7, 4), True), ((2, 3, 6), False)])
def test_k1_backward_matches_plain_autograd(rng, shape, with_bias):
    """K1's closed-form backward (the autograd formula of the op
    `irt::fused_bias_lrelu`) against autograd of the plain version: first
    and second derivatives in float64, and `gradcheck`/`gradgradcheck` of
    the op itself (on the CPU its forward is the plain version)."""
    x, b = _away_from_kink(rng, shape)
    bias = b if with_bias else None
    g = torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    inputs = (x, b) if with_bias else (x,)

    want = torch.autograd.grad(fused_leaky_relu_plain(x, bias), inputs, g,
                               create_graph=True)
    got = torch.autograd.grad(
        torch.ops.irt.fused_bias_lrelu(x, bias, 0.2, math.sqrt(2)),
        inputs, g, create_graph=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)
    # double backward: d(sum(grad_x · u))/d(g, x[, b])
    u = torch.from_numpy(rng.standard_normal(shape))
    want2 = torch.autograd.grad((want[0] * u).sum(), (g,) + inputs,
                                allow_unused=True)
    got2 = torch.autograd.grad((got[0] * u).sum(), (g,) + inputs,
                               allow_unused=True)
    for a, w in zip(got2, want2):
        if w is None:
            assert a is None or not a.any()
        else:
            torch.testing.assert_close(a, w, rtol=0, atol=1e-12)

    fn = lambda *t: torch.ops.irt.fused_bias_lrelu(  # noqa: E731
        t[0], t[1] if with_bias else None, 0.2, math.sqrt(2))
    assert torch.autograd.gradcheck(fn, inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


def test_k1_backward_bf16_dtypes(rng):
    """The backward returns grads in the inputs' dtypes: bf16 x, f32 bias."""
    x, b = _inputs(rng, (4, 6, 16))
    xt = torch.from_numpy(x).bfloat16()
    g = torch.ones_like(xt)
    gx, gb = fused_act.fused_leaky_relu_backward(g, xt, torch.from_numpy(b))
    assert gx.dtype == torch.bfloat16 and gb.dtype == torch.float32
    v = xt.float() + torch.from_numpy(b).bfloat16().float()
    want = torch.where(v >= 0, 1.0, 0.2) * math.sqrt(2)
    torch.testing.assert_close(gx.float(), want.bfloat16().float())
    torch.testing.assert_close(gb, (want.to(torch.float32)
                                    .reshape(-1, 16).sum(0)), rtol=2e-2,
                               atol=0)
