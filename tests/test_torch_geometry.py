"""Port geometry ops (`image_restoration_tpu_torch/ops/geometry.py`) against
`image_restoration_tpu/ops/geometry.py` on the CPU: the port's functions
take a batch, the JAX ones a single image, so each image of the batch is
held against its own JAX call. Values within 1e-4 (relative, for pixel
values up to 255), masks exactly equal. The quads: seeded plate-like ones,
a bowtie and the two degenerate quads of tests/test_serve.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.ops import geometry as jg
from image_restoration_tpu_torch.ops import geometry as tg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _plate_quad(rng, t=T, margin=4):
    """A jittered rectangle in [p1, p2, p5, p4] (TL, TR, BR, BL) order."""
    x0, y0 = rng.integers(margin, t // 2, 2)
    x1 = rng.integers(x0 + 12, t - margin)
    y1 = rng.integers(y0 + 6, t - margin)
    j = lambda: rng.integers(-3, 4, 2)  # noqa: E731
    return np.array([[x0, y0] + j(), [x1, y0] + j(), [x1, y1] + j(),
                     [x0, y1] + j()], np.float32).clip(0, t - 1)


BOWTIE = np.array([[10, 10], [50, 50], [50, 10], [10, 50]], np.float32)
DEGENERATE = [np.array([[16, 63], [63, 0], [63, 0], [0, 38]], np.float32),
              np.array([[16, 63], [16, 63], [63, 0], [0, 38]], np.float32)]


def _quads(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return np.stack([_plate_quad(rng) for _ in range(n)])


def _img(seed, n, c=3):
    return (np.random.default_rng(seed).random((n, T, T, c)) * 255).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_homographies_match_jax():
    quads = np.concatenate([_quads(), BOWTIE[None]])
    square = np.float32([[0, 0], [T, 0], [T, T], [0, T]])
    src = np.broadcast_to(square, quads.shape).copy()
    got_pts = tg.homography_from_points(_t(src), _t(quads)).numpy()
    got_sq = tg.homography_square_to_quad(float(T), _t(quads)).numpy()
    for i, q in enumerate(quads):
        want = np.asarray(jg.homography_from_points(jnp.asarray(square),
                                                    jnp.asarray(q)))
        np.testing.assert_allclose(got_pts[i], want, rtol=1e-4, atol=1e-5)
        want_sq = np.asarray(jg.homography_square_to_quad(float(T),
                                                          jnp.asarray(q)))
        np.testing.assert_allclose(got_sq[i], want_sq, rtol=1e-6, atol=1e-7)
    got_inv = tg.inv3x3(_t(got_sq)).numpy()
    got_det = tg.det3x3(_t(got_sq)).numpy()
    for i in range(len(quads)):
        m = jnp.asarray(got_sq[i])
        np.testing.assert_allclose(got_inv[i], np.asarray(jg.inv3x3(m)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_det[i], np.asarray(jg.det3x3(m)),
                                   rtol=1e-6, atol=1e-7)
    # degenerate quads: non-finite (q2 = q3) or finite but singular
    # (q0 = q1), both as JAX gives them
    deg = np.stack(DEGENERATE)
    got = tg.homography_square_to_quad(float(T), _t(deg)).numpy()
    for i, q in enumerate(deg):
        want = np.asarray(jg.homography_square_to_quad(float(T),
                                                       jnp.asarray(q)))
        np.testing.assert_array_equal(np.isfinite(got[i]), np.isfinite(want))
        np.testing.assert_allclose(got[i][np.isfinite(want)],
                                   want[np.isfinite(want)], rtol=1e-6)
    assert not np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    assert abs(tg.det3x3(_t(got[1])).item()) < 1e-8


def test_warp_perspective_matches_jax():
    """Six channels (the fused pipeline's stacked warp), plate-like quads
    and the bowtie. Values in [0, 1], as JAX's own warp test takes them:
    the projective coordinates may differ from XLA's by a float32 ulp,
    which moves a border tap's weight by ~1e-6 of the value range."""
    quads = np.concatenate([_quads(1), BOWTIE[None]])
    m = tg.homography_square_to_quad(float(T), _t(quads))
    img = _img(2, len(quads), 6) / 255.0
    got = tg.warp_perspective(_t(img), m).numpy()
    assert got.shape == img.shape
    for i in range(len(quads)):
        want = np.asarray(jg.warp_perspective(jnp.asarray(img[i]),
                                              jnp.asarray(m[i].numpy())))
        np.testing.assert_allclose(got[i], want, **TOL)
        assert (want > 0).mean() > 0.05


def test_quad_masks_match_jax():
    """Even-odd fill and the 1.5 px dilation: exactly equal, the bowtie
    (filled, not emptied) and the degenerate quads included."""
    quads = np.concatenate([_quads(3), BOWTIE[None], np.stack(DEGENERATE)])
    got = tg.quad_mask(_t(quads), (T, T)).numpy()
    got_aa = tg.quad_mask_aa(_t(quads), (T, T)).numpy()
    for i, q in enumerate(quads):
        np.testing.assert_array_equal(
            got[i], np.asarray(jg.quad_mask(jnp.asarray(q), (T, T))))
        np.testing.assert_array_equal(
            got_aa[i], np.asarray(jg.quad_mask_aa(jnp.asarray(q), (T, T))))
    assert got[len(quads) - 3].sum() > 100  # the bowtie
    assert (got_aa >= got).all() and (got_aa.sum((1, 2)) > got.sum((1, 2))).all()


@pytest.mark.parametrize("out_hw", [(T, T), (24, 40)])
def test_crop_and_pad_resize_match_jax(out_hw):
    quads = np.concatenate([_quads(4), BOWTIE[None], np.stack(DEGENERATE)])
    img = _img(5, len(quads))
    bbox = tg.bbox_of_quad(_t(quads), (T, T))
    crop = tg.crop_resize(_t(img), bbox, out_hw).numpy()
    pad = tg.pad_resize(_t(img), bbox, out_hw).numpy()
    oh, ow = out_hw
    ax = tg._axis_coords(bbox[0], bbox[2], ow, float(ow)).numpy()
    for i, q in enumerate(quads):
        jb = jg.bbox_of_quad(jnp.asarray(q), (T, T))
        np.testing.assert_array_equal([b[i].item() for b in bbox],
                                      [float(v) for v in jb])
        np.testing.assert_allclose(ax[i], np.asarray(jg._axis_coords(
            jb[0], jb[2], ow, float(ow))), rtol=0, atol=1e-5)
        np.testing.assert_allclose(crop[i], np.asarray(jg.crop_resize(
            jnp.asarray(img[i]), jb, out_hw)), **TOL)
        np.testing.assert_allclose(pad[i], np.asarray(jg.pad_resize(
            jnp.asarray(img[i]), jb, out_hw)), **TOL)


def test_bilinear_grid_matches_jax():
    """The separable gather with taps clamped to a window."""
    img = _img(6, 2)
    rng = np.random.default_rng(7)
    sy = (rng.random((2, 9)) * 70 - 3).astype(np.float32)
    sx = (rng.random((2, 11)) * 70 - 3).astype(np.float32)
    yr = (torch.tensor([3.0, 0.0]), torch.tensor([40.0, 63.0]))
    xr = (torch.tensor([5.0, 10.0]), torch.tensor([60.0, 20.0]))
    got = tg._bilinear_grid(_t(img), _t(sy), _t(sx), yr, xr).numpy()
    for i in range(2):
        want = jg._bilinear_grid(
            jnp.asarray(img[i]), jnp.asarray(sy[i]), jnp.asarray(sx[i]),
            (yr[0][i].item(), yr[1][i].item()),
            (xr[0][i].item(), xr[1][i].item()))
        np.testing.assert_allclose(got[i], np.asarray(want), **TOL)
