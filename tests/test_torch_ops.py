"""Port ops against the JAX package: upfirdn2d and its wrappers, the NHWC
convs, the modulated conv in every sample mode, and the cv2-style resize.
Same numpy inputs to both; f32; atol 1e-5 (float32 sums in another order)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_restoration_tpu.ops import upfirdn as jup
from image_restoration_tpu.ops import modulated_conv as jmc
from image_restoration_tpu_torch.ops import upfirdn as tup
from image_restoration_tpu_torch.ops import modulated_conv as tmc


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the packages export a function `resize` over the submodule's name
jrs = importlib.import_module("image_restoration_tpu.ops.resize")
trs = importlib.import_module("image_restoration_tpu_torch.ops.resize")

ATOL = 1e-5
K1D = (1.0, 3.0, 3.0, 1.0)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_make_resample_kernel():
    _close(tup.make_resample_kernel(K1D), jup.make_resample_kernel(K1D),
           atol=0)


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (3, 1)),
    (1, 1, (0, 0)), (2, 1, (-1, 2)), (1, 2, (2, -1)),
])
def test_upfirdn2d_matches_jax(rng, up, down, pad):
    x = rng.standard_normal((2, 8, 9, 3)).astype(np.float32)
    k = rng.random((4, 3)).astype(np.float32)  # asymmetric: checks the flip
    want = jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down,
                         pad=pad)
    got = tup.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up=up,
                        down=down, pad=pad)
    assert got.is_contiguous()
    _close(got, want)


@pytest.mark.parametrize("which", ["upsample", "smooth_up", "smooth_down",
                                   "smooth_down_k1"])
def test_upfirdn_wrappers_match_jax(rng, which):
    x = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    kj = jnp.asarray(K1D)
    if which == "upsample":
        want, got = jup.upfirdn_upsample(xj, kj), tup.upfirdn_upsample(xt, K1D)
    elif which == "smooth_up":
        want = jup.upfirdn_smooth(xj, kj, upsample_factor=2, kernel_size=3)
        got = tup.upfirdn_smooth(xt, K1D, upsample_factor=2, kernel_size=3)
    elif which == "smooth_down":
        want = jup.upfirdn_smooth(xj, kj, downsample_factor=2, kernel_size=3)
        got = tup.upfirdn_smooth(xt, K1D, downsample_factor=2, kernel_size=3)
    else:
        want = jup.upfirdn_smooth(xj, kj, downsample_factor=2, kernel_size=1)
        got = tup.upfirdn_smooth(xt, K1D, downsample_factor=2, kernel_size=1)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (1, 0)])
def test_conv2d_matches_jax(rng, stride, padding):
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)  # OIHW
    want = jmc.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                      stride=stride, padding=padding)
    got = tmc.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                     padding=padding)
    assert got.is_contiguous()
    _close(got, want)


def test_conv_transpose2d_matches_jax(rng):
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    want = jmc.conv_transpose2d(jnp.asarray(x),
                                jnp.asarray(w.transpose(2, 3, 1, 0)))
    got = tmc.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("mode", [None, "upsample", "downsample"])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv2d_matches_jax(rng, mode, demodulate):
    """The shapes of tests/test_more_golden.py: 8 → 12 channels, 3×3,
    16×16, batch 2, style from a 6-wide code."""
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((12, 8, 3, 3)) / np.sqrt(72)).astype(np.float32)
    s = (rng.standard_normal((2, 8)) + 1.0).astype(np.float32)
    want = jmc.modulated_conv2d(jnp.asarray(x),
                                jnp.asarray(w.transpose(2, 3, 1, 0)),
                                jnp.asarray(s), demodulate=demodulate,
                                sample_mode=mode)
    got = tmc.modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(s), demodulate=demodulate,
                               sample_mode=mode)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("n_in,n_out", [(16, 32), (37, 16), (64, 64), (5, 1),
                                        (1, 4)])
def test_cv2_resize_matrix_is_the_jax_one(n_in, n_out):
    np.testing.assert_array_equal(trs.cv2_resize_matrix(n_in, n_out),
                                  jrs.cv2_resize_matrix(n_in, n_out))


def test_cv2_resize_matrix_rejects_unported_interpolation():
    with pytest.raises(ValueError):
        trs.cv2_resize_matrix(8, 4, "lanczos")


@pytest.mark.parametrize("out_hw", [(32, 48), (11, 7), (256, 256)])
def test_resize_matches_jax(rng, out_hw):
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    want = jrs.resize(jnp.asarray(x), out_hw)
    got = trs.resize(torch.from_numpy(x), out_hw)
    _close(got, want)
    want3 = jrs.resize(jnp.asarray(x[0]), out_hw)
    _close(trs.resize(torch.from_numpy(x[0]), out_hw), want3)
