"""Kernel K3's plain version (`conv3x3_im2col_plain`) against the Pallas
kernel `conv3x3_im2col` in interpret mode, the wrapper's dispatch and checks,
and the probe entry point's control flow on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.ops.pallas.im2col_conv import (
    conv3x3_im2col as pallas_conv3x3_im2col)
from image_restoration_tpu_torch.ops.im2col_conv import (
    conv3x3_im2col, conv3x3_im2col_plain)
from image_restoration_tpu_torch.scripts import probe_conv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cin,cout,bh", [(64, 192, 4), (32, 160, 8),
                                         (32, 64, 8)])
def test_plain_f32_matches_pallas_interpret(rng, cin, cout, bh):
    """The widened stage channel shapes at the JAX test's size and
    tolerance (`tests/test_ops.py:278-293`), float32 in and out."""
    x = rng.standard_normal((2, 18, 26, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(w), bh=bh, out_dtype=jnp.float32,
        interpret=True))
    for fn in (conv3x3_im2col_plain, conv3x3_im2col):  # CPU → plain
        got = fn(_t(x), _t(w), bh=bh, out_dtype=torch.float32)
        assert got.shape == (2, 16, 24, cout) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_bf16_out_matches_pallas_interpret(rng):
    """bf16 in and out, as the probe runs it: within one bf16 ulp of the
    Pallas value, plus 1e-5 of max|ref| where a sum cancels to near zero
    (both sum the same float32 products, in another order)."""
    cin, cout = 64, 192
    x = jnp.asarray(rng.standard_normal((1, 10, 18, cin)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((3, 3, cin, cout)) * 0.1,
                    jnp.bfloat16)
    want = np.asarray(pallas_conv3x3_im2col(x, w, bh=4, interpret=True),
                      np.float32)
    got = conv3x3_im2col_plain(_t(np.asarray(x, np.float32)).bfloat16(),
                               _t(np.asarray(w, np.float32)).bfloat16(),
                               bh=4)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 8, 16, cout)
    err = np.abs(got.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(err <= ulp + 1e-5 * np.abs(want).max())
    assert (err > 0).mean() < 0.01  # rounding flips only


def test_wrapper_dispatch_and_checks(rng):
    """CPU tensors take the plain version and count no launch; a meta
    tensor, a Cin mismatch, H % bh != 0 and an unsupported out_dtype raise,
    as `int8_conv3x3_requant` does for K2."""
    x = _t(rng.standard_normal((1, 10, 7, 32)).astype(np.float32))
    w = _t(rng.standard_normal((3, 3, 32, 16)).astype(np.float32))
    before = conv3x3_im2col.launches
    out = conv3x3_im2col(x, w)
    assert out.shape == (1, 8, 5, 16) and out.dtype == torch.bfloat16
    assert torch.equal(out, conv3x3_im2col_plain(x, w))
    assert conv3x3_im2col.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_im2col(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="input channels"):
        conv3x3_im2col(x, w[:, :, :16])
    with pytest.raises(ValueError, match="must divide by bh"):
        conv3x3_im2col(x, w, bh=3)
    with pytest.raises(ValueError, match="out_dtype"):
        conv3x3_im2col(x, w, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        conv3x3_im2col(x[0], w)


def test_probe_stage_runs_on_cpu(rng, capsys):
    """One probe stage on a 16² bf16 tensor on the CPU (plain version, host
    clock): within its 2e-2 gate, both rates printed."""
    for name, cin, cout, bh in probe_conv.SHAPES:
        x = _t(rng.random((1, 18, 18, cin), np.float32)).bfloat16()
        w = _t(rng.random((3, 3, cin, cout), np.float32) - 0.5).bfloat16()
        row = probe_conv.probe_stage(name, x, w, bh)
        assert (row["cin"], row["cout"], row["size"]) == (cin, cout, 16)
        assert row["rel_err"] < 2e-2
    assert "cpu-bf16" in capsys.readouterr().out
