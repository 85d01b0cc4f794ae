"""The port's counterparts of the JAX package's last public functions,
against the JAX functions on the same seeded numpy inputs: the device
metrics `psnr_batch` / `ssim_batch` (1e-5 relative), `cv2_resize_matrix`'s
`area` and `bicubic` rows (bit-equal) and `resize` in those modes (1e-6,
and cv2.resize at `tests/test_ops.py`'s tolerance), `upfirdn_downsample`
(1e-6), `random_gaussian_noise` and `random_rect_masks` (bit-equal on
JAX's draws, and by statistics on their own), `crop_border` and
`sizeof_fmt` (exact)."""

import functools
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_restoration_tpu.data import degradations as jdeg
from image_restoration_tpu.data import masks as jmasks
from image_restoration_tpu.metrics import psnr_ssim as jps
from image_restoration_tpu.ops import upfirdn as jup
from image_restoration_tpu.utils import img_util as jimg
from image_restoration_tpu.utils import misc as jmisc
from image_restoration_tpu_torch.data import degradations as tdeg
from image_restoration_tpu_torch.data import masks as tmasks
from image_restoration_tpu_torch.metrics import psnr_ssim as tps
from image_restoration_tpu_torch.ops import upfirdn as tup
from image_restoration_tpu_torch.utils import img_util as timg
from image_restoration_tpu_torch.utils import misc as tmisc


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


def _batch_pair(seed=5, shape=(4, 48, 40, 3)):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("metric", ["psnr_batch", "ssim_batch"])
def test_device_metric_matches_jax(metric):
    pred, gt = _batch_pair()
    want = np.asarray(getattr(jps, metric)(jnp.asarray(pred),
                                           jnp.asarray(gt)))
    got = getattr(tps, metric)(torch.from_numpy(pred), torch.from_numpy(gt))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_device_metrics_close_to_host():
    """As tests/test_losses_metrics.py's JAX test of the same name: PSNR
    within 1e-3 of the host score, SSIM in (0.5, 1]."""
    pred, gt = _batch_pair()
    dev = tps.psnr_batch(torch.from_numpy(pred), torch.from_numpy(gt))
    for i in range(len(pred)):
        host = tps.calculate_psnr(pred[i] * 255, gt[i] * 255, crop_border=0)
        np.testing.assert_allclose(float(dev[i]), host, rtol=1e-3)
    ssim = tps.ssim_batch(torch.from_numpy(pred), torch.from_numpy(gt))
    assert bool(((ssim > 0.5) & (ssim <= 1.0)).all())
    same = tps.psnr_batch(torch.from_numpy(pred), torch.from_numpy(pred))
    np.testing.assert_allclose(same.numpy(), 120.0)   # the 1e-12 floor


@pytest.mark.parametrize("interp", ["area", "bicubic", "cubic"])
@pytest.mark.parametrize("n_in,n_out", [(16, 32), (37, 16), (64, 64), (5, 1),
                                        (1, 4)])
def test_cv2_resize_matrix_modes_are_the_jax_ones(n_in, n_out, interp):
    np.testing.assert_array_equal(
        trs.cv2_resize_matrix(n_in, n_out, interp),
        jrs.cv2_resize_matrix(n_in, n_out, interp))


@pytest.mark.parametrize("interp", ["area", "bicubic"])
@pytest.mark.parametrize("out_hw", [(32, 48), (11, 7), (8, 12)])
def test_resize_modes_match_jax(rng, interp, out_hw):
    x = rng.random((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jrs.resize(jnp.asarray(x), out_hw, interp))
    got = trs.resize(torch.from_numpy(x), out_hw, interp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got3 = trs.resize(torch.from_numpy(x[0]), out_hw, interp)
    np.testing.assert_allclose(got3.numpy(), want[0], rtol=1e-6, atol=1e-6)


# tests/test_ops.py::test_cv2_resize_matches_cv2's shapes and tolerance, at
# the cases it runs for these modes (it skips `area` upscaling)
@pytest.mark.parametrize("interp,cv2_flag,out_size", [
    ("bicubic", "INTER_CUBIC", (8, 12)),
    ("bicubic", "INTER_CUBIC", (32, 48)),
    ("area", "INTER_AREA", (8, 12)),
])
def test_resize_modes_match_cv2(rng, interp, cv2_flag, out_size):
    import cv2
    img = rng.random((16, 24, 3)).astype(np.float32)
    want = cv2.resize(img, (out_size[1], out_size[0]),
                      interpolation=getattr(cv2, cv2_flag))
    got = trs.resize(torch.from_numpy(img), out_size, interp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_upfirdn_downsample_matches_jax(rng):
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    k = (1.0, 3.0, 3.0, 1.0)
    want = np.asarray(jup.upfirdn_downsample(jnp.asarray(x), jnp.asarray(k)))
    got = tup.upfirdn_downsample(torch.from_numpy(x), k)
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_noise_draws(key, shape, sigma_range, gray_prob):
    """The draws JAX's `random_gaussian_noise` makes from `key`, and its
    noise (one jit: eager JAX compiles each op alone)."""
    n = shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    sigma = jax.random.uniform(k1, (n, 1, 1, 1), minval=sigma_range[0],
                               maxval=sigma_range[1]) / 255.0
    draws = dict(sigma=sigma, normal=jax.random.normal(k2, shape),
                 gray=jax.random.bernoulli(k3, gray_prob, (n, 1, 1, 1)))
    return draws, jdeg.random_gaussian_noise(key, shape, sigma_range,
                                             gray_prob)


def test_random_gaussian_noise_on_jax_draws():
    shape, rng_, gp = (6, 12, 10, 3), (5.0, 30.0), 0.5
    draws, want = _jax_noise_draws(jax.random.PRNGKey(3), shape, rng_, gp)
    got = tdeg.gaussian_noise({k: torch.tensor(np.asarray(v))
                               for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_random_gaussian_noise_statistics():
    """σ per sample inside the range (the noise's own spread within 5% of
    its drawn σ); gray samples (equal channels) within 4σ of gray_prob
    over 4096 samples."""
    lo, hi = 5.0, 30.0
    g = torch.Generator().manual_seed(17)
    noise = tdeg.random_gaussian_noise(g, (64, 32, 32, 3), (lo, hi), 0.0)
    assert noise.shape == (64, 32, 32, 3)
    drawn = tdeg.sample_gaussian_noise(torch.Generator().manual_seed(17),
                                       (64, 32, 32, 3), (lo, hi), 0.0)
    sigma = drawn["sigma"].flatten()
    assert bool(((sigma >= lo / 255) & (sigma <= hi / 255)).all())
    spread = noise.flatten(1).std(dim=1)
    np.testing.assert_allclose(spread.numpy(), sigma.numpy(), rtol=0.05)

    n, p = 4096, 0.3
    noise = tdeg.random_gaussian_noise(torch.Generator().manual_seed(18),
                                       (n, 2, 2, 3), (lo, hi), p)
    gray = (noise == noise[..., :1]).flatten(1).all(dim=1)
    share = float(gray.float().mean())
    assert abs(share - p) <= 4 * math.sqrt(p * (1 - p) / n), share


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_rect_draws(key, shape, k, lo, hi):
    """The four uniforms JAX's `random_rect_masks` draws from `key`, and
    its masks."""
    keys = jax.random.split(key, 4)
    draws = {name: jax.random.uniform(kk, (shape[0], 1, 1, k))
             for name, kk in zip(("y0", "x0", "h", "w"), keys)}
    return draws, jmasks.random_rect_masks(key, shape, k, lo, hi)


def test_random_rect_masks_on_jax_draws():
    shape, k, lo, hi = (5, 24, 20, 3), 3, 0.1, 0.4
    draws, want = _jax_rect_draws(jax.random.PRNGKey(11), shape, k, lo, hi)
    got = tmasks.rect_masks({n: torch.tensor(np.asarray(v))
                             for n, v in draws.items()}, shape[1], shape[2],
                            lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_rect_masks_coverage():
    """The masks' covered share within 3σ of its expectation: a pixel at
    (y, x) lies in one rectangle w.p. P(y)·P(x), P(y) = E_f[min(f·h, y)]/h
    with f ~ U(min_frac, max_frac), and in any of k independent ones w.p.
    1 − (1 − P(y)·P(x))^k."""
    n, h, w, k, lo, hi = 512, 32, 24, 3, 0.1, 0.4
    masks = tmasks.random_rect_masks(torch.Generator().manual_seed(4),
                                     (n, h, w, 3), k, lo, hi)
    assert masks.shape == (n, h, w, 1)
    f = lo + (np.arange(4096) + 0.5) / 4096 * (hi - lo)

    def p(size):
        return np.minimum(f[None] * size,
                          np.arange(size)[:, None]).mean(axis=1) / size

    expected = float(np.mean(1 - (1 - p(h)[:, None] * p(w)[None]) ** k))
    per = masks.flatten(1).mean(dim=1).numpy()
    assert abs(per.mean() - expected) <= 3 * per.std() / math.sqrt(n), (
        per.mean(), expected)


def test_crop_border_matches_jax(rng):
    hwc = rng.random((10, 12, 3)).astype(np.float32)
    nhwc = rng.random((2, 10, 12, 3)).astype(np.float32)
    for imgs in (hwc, nhwc, [hwc, nhwc], (nhwc, hwc)):
        for b in (0, 2):
            want = jimg.crop_border(imgs, b)
            got = timg.crop_border(imgs, b)
            if isinstance(want, (list, tuple)):
                assert type(got) is type(want) and len(got) == len(want)
                for a, c in zip(got, want):
                    np.testing.assert_array_equal(a, c)
            else:
                np.testing.assert_array_equal(got, want)
    assert timg.crop_border(hwc, 0) is hwc
    t = torch.from_numpy(nhwc)
    assert timg.crop_border(t, 3).shape == (2, 4, 6, 3)


def test_sizeof_fmt_matches_jax():
    for size in (0, 1, 1023, 1024, 1536, 10 ** 6, 3 * 2 ** 30, 2 ** 70,
                 2 ** 90, -5000):
        assert tmisc.sizeof_fmt(size) == jmisc.sizeof_fmt(size)
        assert tmisc.sizeof_fmt(size, "iB") == jmisc.sizeof_fmt(size, "iB")
