"""The port's degradation chain and data layer against the JAX package.

Random streams cannot match across frameworks, so every random op is held
with its parameters drawn by JAX's keys exactly as the JAX function draws
them, handed to the JAX op and to the port's apply half. The chain as a
whole is held by statistics. Tolerances: float32 ops ≤1e-5 (absolute, on
values in [0, 1]) unless a test says otherwise; median blur bit-equal.
"""

import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import degradations as JD
from image_restoration_tpu.data import pipelines as JP
from image_restoration_tpu.data import datasets as jax_datasets
from image_restoration_tpu.data.datasets import \
    FFHQDegradationDataset as JaxFFHQ
from image_restoration_tpu.data.loader import EnlargedSampler as JaxSampler
from image_restoration_tpu.data.pyblur_bank import \
    build_pyblur_bank as jax_bank
from image_restoration_tpu.ops.filter2d import filter2d as jfilter2d
from image_restoration_tpu.ops.filter2d import usm_sharp as jusm
from image_restoration_tpu.ops.resize import \
    dynamic_resize_matrix as jdynamic
from image_restoration_tpu.utils.diffjpeg import diff_jpeg as jdiff_jpeg
from image_restoration_tpu_torch.data import build_dataloader, build_dataset
from image_restoration_tpu_torch.data import degradations as TD
from image_restoration_tpu_torch.data import pipelines as TP
from image_restoration_tpu_torch.data.pyblur_bank import build_pyblur_bank
from image_restoration_tpu_torch.ops.filter2d import filter2d, usm_sharp
from image_restoration_tpu_torch.ops.resize import dynamic_resize_matrix
from image_restoration_tpu_torch.utils.diffjpeg import diff_jpeg

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _img(seed, n=3, h=24, w=32, c=3, levels=False):
    x = np.random.default_rng(seed).random((n, h, w, c)).astype(np.float32)
    if levels:  # an 8-bit image
        x = np.round(x * 255.0).astype(np.float32) / 255.0
    return x


def test_pyblur_bank_equals_jax():
    np.testing.assert_array_equal(build_pyblur_bank(), jax_bank())


@pytest.mark.parametrize("shared", [False, True])
def test_filter2d_matches_jax(shared):
    x = _img(0)
    rng = np.random.default_rng(1)
    k = rng.random((21, 21) if shared else (3, 21, 21)).astype(np.float32)
    k /= k.sum(axis=(-2, -1), keepdims=True)  # unit mass, as blur kernels
    _close(filter2d(_t(x), _t(k)), jfilter2d(jnp.asarray(x), jnp.asarray(k)))


def test_usm_sharp_matches_jax():
    x = _img(2, h=48, w=48)
    _close(usm_sharp(_t(x), radius=9), jusm(jnp.asarray(x), radius=9))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "area"])
def test_dynamic_resize_matrix_matches_jax(mode):
    """A batch of traced scales and valid lengths at once, against JAX's
    one-scale function at each."""
    scales = np.asarray([0.25, 1.0, 2.5, 7.3], np.float32)
    valid = np.asarray([3, 12, 5, 1], np.int32)
    got = dynamic_resize_matrix(12, 17, _t(scales), _t(valid), mode)
    want = np.stack([jdynamic(12, 17, jnp.float32(s), jnp.int32(v), mode)
                     for s, v in zip(scales, valid)])
    _close(got, want, 1e-6)


def _jpeg_close(got, want):
    """JPEG with rounding: a DCT coefficient a float ulp from .5 may round
    the other way on one side, which moves its whole block (8×8 luma,
    16×16 chroma) by up to one quantization step. At most 1 block in 16
    (over the batch) may differ by more than 1e-5, by at most 0.1."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    n, h, w, c = got.shape
    d = np.abs(got - want)[:, :h - h % 8, :w - w % 8]
    blocks = d.reshape(n, h // 8, 8, w // 8, 8, c).max(axis=(2, 4, 5))
    assert np.mean(blocks > 1e-5) <= 1 / 16, blocks
    assert d.max() <= 0.1


def test_diff_jpeg_matches_jax():
    """The differentiable form against JAX ≤1e-5; the rounded form as
    `_jpeg_close` says."""
    x = _img(3, n=2, h=20, w=36)
    q = np.asarray([35.0, 80.0], np.float32)
    _close(diff_jpeg(_t(x), _t(q)), jdiff_jpeg(jnp.asarray(x),
                                                jnp.asarray(q)), 1e-5)
    _jpeg_close(diff_jpeg(_t(x), _t(q), differentiable=False),
                jdiff_jpeg(jnp.asarray(x), jnp.asarray(q),
                           differentiable=False))


# ------------------------------------------------------------ kernels

KINDS = ["iso", "aniso", "generalized_iso", "generalized_aniso",
         "plateau_iso", "plateau_aniso", "motion", "average", "median",
         "bilateral", "pyblur", "sinc"]


def _jax_kernel_params(key, kernel_prob, bank_size, size_range=(7, 21),
                       sigma=(0.2, 3.0)):
    """The parameters `random_mixed_kernel` draws from `key`, drawn the
    same way (`degradations.py:141-170`)."""
    keys = jax.random.split(key, 8)
    probs = jnp.asarray(kernel_prob, jnp.float32)
    lo, hi = size_range
    rot, bg, bp = (-math.pi, math.pi), (0.5, 8.0), (0.5, 8.0)
    u = (lambda k, r: float(jax.random.uniform(k, (), minval=r[0],
                                               maxval=r[1])))
    return dict(
        type_idx=int(jax.random.categorical(keys[0],
                                            jnp.log(probs + 1e-12))),
        sig_x=u(keys[1], sigma), sig_y=u(keys[2], sigma),
        theta=u(keys[3], rot), betag=u(keys[4], bg), betap=u(keys[5], bp),
        ksize=lo + 2 * int(jax.random.randint(keys[6], (), 0,
                                              (hi - lo) // 2 + 1)),
        horizontal=bool(jax.random.bernoulli(keys[7])),
        bank_idx=int(jax.random.randint(keys[7], (), 0, bank_size)))


def _jax_kernels(keys, kinds, prob, bank):
    """JAX's `random_mixed_kernel` at each key (vmapped, as the pipeline
    calls it)."""
    def one(k):
        return JD.random_mixed_kernel(
            k, kinds, prob, pad_to=21, kernel_size_range=(7, 21),
            sigma_x_range=(0.2, 3.0), sigma_y_range=(0.2, 3.0),
            extra_bank=jnp.asarray(bank))[0]
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def _stack_params(ps):
    dtypes = dict(type_idx=torch.long, ksize=torch.long,
                  horizontal=torch.bool, bank_idx=torch.long)
    return {k: torch.tensor([p[k] for p in ps],
                            dtype=dtypes.get(k, torch.float32))
            for k in ps[0]}


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_family_matches_jax(kind):
    bank = jax_bank() if kind == "pyblur" else JD.sinc_kernel_bank(21, 16)
    kinds = [kind, "iso"]  # type 0 always: probability 1 on `kind`
    prob = (1.0, 0.0)
    ks = jax.random.split(jax.random.PRNGKey(KINDS.index(kind)), 4)
    want = _jax_kernels(ks, kinds, prob, bank)
    params = _stack_params([_jax_kernel_params(k, prob, bank.shape[0])
                            for k in ks])
    assert params["type_idx"].eq(0).all()
    got = TD.mixed_kernel(params, kinds, 21, _t(bank))
    _close(got, want, 1e-6)


def test_mixed_kernel_gathers_by_type():
    """Every type of the production list in one batch, each sample's kernel
    gathered by its own drawn index."""
    kinds = ["iso", "aniso", "motion", "average", "median", "bilateral",
             "pyblur"]
    prob = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.4)
    bank = jax_bank()
    ks = jax.random.split(jax.random.PRNGKey(5), 24)
    want = _jax_kernels(ks, kinds, prob, bank)
    params = _stack_params([_jax_kernel_params(k, prob, bank.shape[0])
                            for k in ks])
    assert len(set(params["type_idx"].tolist())) >= 5
    _close(TD.mixed_kernel(params, kinds, 21, _t(bank)), want, 1e-6)


def test_sample_mixed_kernel_shares_follow_kernel_prob():
    """The port's own draw: each type's share over 4000 samples within
    0.03 of kernel_prob; sizes odd and in range; σ in range; and
    `random_mixed_kernel` (draw and build) gives unit-mass kernels of the
    drawn types."""
    prob = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.4)
    g = torch.Generator().manual_seed(0)
    p = TD.sample_mixed_kernel(g, 4000, prob, kernel_size_range=(11, 21),
                               sigma_x_range=(0.1, 10), bank_size=120)
    kinds = ["iso", "aniso", "motion", "average", "median", "bilateral",
             "pyblur"]
    kernels, idx = TD.random_mixed_kernel(
        g, 64, kinds, prob, 21, _t(jax_bank()), kernel_size_range=(11, 21))
    assert kernels.shape == (64, 21, 21) and idx.shape == (64,)
    torch.testing.assert_close(kernels.sum(dim=(1, 2)), torch.ones(64))
    share = np.bincount(p["type_idx"].numpy(), minlength=7) / 4000
    np.testing.assert_allclose(share, prob, atol=0.03)
    ks = p["ksize"].numpy()
    assert ks.min() == 11 and ks.max() == 21 and np.all(ks % 2 == 1)
    assert 0.1 <= p["sig_x"].min() and p["sig_x"].max() <= 10
    assert 0 <= p["bank_idx"].min() and p["bank_idx"].max() < 120


# ---------------------------------------------------- nonlinear blurs


@pytest.mark.parametrize("ksize", [3, 15])
def test_median_blur_bit_equal_to_jax_and_cv2(ksize):
    x = _img(4, levels=True)
    got = TD.median_blur(_t(x), ksize).numpy()
    np.testing.assert_array_equal(got, np.asarray(JD.median_blur(
        jnp.asarray(x), ksize)))
    u8 = np.round(x * 255).astype(np.uint8)
    ref = np.stack([cv2.medianBlur(im, ksize) for im in u8])
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), ref)


def test_bilateral_blur_matches_jax():
    x = _img(5)
    _close(TD.bilateral_blur(_t(x), 7, 180.0, 180.0),
           JD.bilateral_blur(jnp.asarray(x), 7, 180.0, 180.0))


@pytest.mark.parametrize("slots", [None, 2])
def test_apply_nonlinear_blur_matches_jax(slots):
    kinds = ["iso", "median", "bilateral"]
    x = _img(6, n=5, levels=True)
    idx = np.asarray([1, 2, 0, 1, 2], np.int32)
    key = jax.random.PRNGKey(3)
    sigma = jax.random.uniform(key, (), minval=150.0, maxval=250.0)
    want = JD.apply_nonlinear_blur(jnp.asarray(x), jnp.asarray(idx), kinds,
                                   key, ksize=5, slots=slots)
    got = TD.apply_nonlinear_blur(_t(x), _t(idx).long(), kinds,
                                  _t(np.float32(sigma)), ksize=5,
                                  slots=slots)
    _close(got, want)


# ------------------------------------------------------------- noises


def test_gaussian_noise_matches_jax():
    x = _img(7)
    key = jax.random.PRNGKey(8)
    want = JD.add_gaussian_noise(key, jnp.asarray(x), (0, 20), 0.5)
    k1, k2, k3 = jax.random.split(key, 3)
    n = x.shape[0]
    params = dict(
        sigma=_t(jax.random.uniform(k1, (n, 1, 1, 1), minval=0,
                                    maxval=20) / 255.0),
        normal=_t(jax.random.normal(k2, x.shape)),
        gray=_t(jax.random.bernoulli(k3, 0.5, (n, 1, 1, 1))))
    _close(TD.add_gaussian_noise(_t(x), params), want)


def test_poisson_noise_matches_jax():
    x = _img(9)
    key = jax.random.PRNGKey(10)
    want = JD.add_poisson_noise(key, jnp.asarray(x), (0.0, 1.0), 0.5)
    k1, k2, k3 = jax.random.split(key, 3)
    n = x.shape[0]
    scale = jax.random.uniform(k1, (n, 1, 1, 1), minval=0.0, maxval=1.0)
    gray = jax.random.bernoulli(k3, 0.5, (n, 1, 1, 1))
    src = jnp.where(gray, jnp.mean(jnp.asarray(x), -1, keepdims=True),
                    jnp.asarray(x))
    counts = jax.random.poisson(k2, jnp.clip(src, 0, 1) * 256.0)
    got = TD.add_poisson_noise(_t(x), dict(scale=_t(scale), gray=_t(gray)),
                               counts=_t(counts))
    _close(got, want)


def test_jpeg_compression_matches_jax():
    x = _img(11, n=2, h=32, w=32)
    key = jax.random.PRNGKey(12)
    want = np.asarray(JD.add_jpeg_compression(key, jnp.asarray(x), (30, 95)))
    q = jax.random.uniform(key, (2,), minval=30, maxval=95)
    _jpeg_close(TD.add_jpeg_compression(_t(x), _t(q)), want)


@pytest.mark.parametrize("with_mid", [False, True])
def test_random_down_up_matches_jax(with_mid):
    """Per-sample scales; the mid op (noise at the low resolution) sees the
    same canvas and valid extents on both sides."""
    x = _img(13, n=4, h=40, w=28)
    key = jax.random.PRNGKey(14)
    noise = np.random.default_rng(15).standard_normal(
        (4, 10, 7, 3)).astype(np.float32) * 0.05

    def jmid(small, valid):
        return small + jnp.asarray(noise)

    def tmid(small, valid):
        return small + _t(noise)

    want, wsmall, (wvh, wvw) = jax.jit(lambda k, im: JD.random_down_up(
        k, im, (4.0, 12.0), "bilinear", jmid if with_mid else None))(
        key, jnp.asarray(x))
    scale = jax.random.uniform(key, (4,), minval=4.0, maxval=12.0)
    got, small, (vh, vw) = TD.random_down_up(_t(x), _t(scale), (4.0, 12.0),
                                             "bilinear",
                                             tmid if with_mid else None)
    np.testing.assert_array_equal(vh.numpy(), np.asarray(wvh))
    np.testing.assert_array_equal(vw.numpy(), np.asarray(wvw))
    _close(small, wsmall)
    _close(got, want)


# ------------------------------------------------------ colour and gray


def test_color_jitter_matches_jax():
    x = _img(16)
    key = jax.random.PRNGKey(17)
    want = JD.color_jitter(key, jnp.asarray(x), 20 / 255)
    jit = jax.random.uniform(key, (3, 1, 1, 3), minval=-20 / 255,
                             maxval=20 / 255)
    _close(TD.color_jitter(_t(x), _t(jit)), want)


def test_color_jitter_pt_matches_jax():
    x = _img(18)
    key = jax.random.PRNGKey(19)
    want = JD.color_jitter_pt(key, jnp.asarray(x))
    kb, kc, ks, kh = jax.random.split(key, 4)
    s = (3, 1, 1, 1)
    u = (lambda k, lo, hi: _t(jax.random.uniform(k, s, minval=lo,
                                                 maxval=hi)))
    params = dict(brightness=u(kb, 0.5, 1.5), contrast=u(kc, 0.5, 1.5),
                  saturation=u(ks, 0, 1.5),
                  hue=u(kh, -0.1, 0.1) * 2 * math.pi)
    _close(TD.color_jitter_pt(_t(x), params), want)


def test_random_grayscale_matches_jax():
    x = _img(20, n=6)
    key = jax.random.PRNGKey(21)
    want = JD.random_grayscale(key, jnp.asarray(x), 0.5)
    gate = jax.random.bernoulli(key, 0.5, (6, 1, 1, 1))
    assert 0 < int(gate.sum()) < 6
    _close(TD.random_grayscale(_t(x), _t(gate)), want)


def test_perspective_roundtrip_matches_jax():
    """Bilinear warps there and back; ≤1e-4 on 99% of values (a sample
    point a float ulp from a pixel edge may take the other neighbour)."""
    x = _img(22, n=2, h=32, w=32)
    key = jax.random.PRNGKey(23)
    want = np.asarray(jax.jit(JD.perspective_roundtrip)(key,
                                                        jnp.asarray(x)))
    down, u, factor = [], [], []
    for k in jax.random.split(key, 2):
        k1, k2, k3 = jax.random.split(k, 3)
        down.append(float(np.asarray((3.0, 5.0))[
            int(jax.random.randint(k1, (), 0, 2))]))
        factor.append(int(jax.random.randint(k3, (), 0, 3)))
        u.append(np.asarray(jax.random.uniform(k2, (4, 2))))
    params = dict(down=torch.tensor(down), u=_t(np.stack(u)),
                  factor=torch.tensor(factor))
    got = TD.perspective_roundtrip(_t(x), params).numpy()
    assert np.mean(np.abs(got - want) <= 1e-4) >= 0.99


# ---------------------------------------------------------- the chain


def _ffhq_cfg():
    return JP.FFHQDegradationConfig(), TP.FFHQDegradationConfig()


def test_ffhq_config_defaults_match_jax():
    j, t = _ffhq_cfg()
    assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
        {f: getattr(t, f) for f in t.__dataclass_fields__}


def test_ffhq_apply_matches_jax_without_nonlinear_types():
    """The whole chain with its parameters pinned: with blur types whose
    kernels JAX builds from the same draws, no jitter and no JPEG (whose
    rounding may flip), the port's apply equals JAX's degrade at the
    parameters drawn from JAX's keys (`pipelines.py:71-136`)."""
    kinds, prob = ("iso", "aniso"), (0.5, 0.5)
    jcfg = JP.FFHQDegradationConfig(
        kernel_list=kinds, kernel_prob=prob, jpeg_range=None,
        color_jitter_prob=None, color_jitter_pt_prob=None, gray_prob=0.0)
    tcfg = TP.FFHQDegradationConfig(
        kernel_list=kinds, kernel_prob=prob, jpeg_range=None,
        color_jitter_prob=None, color_jitter_pt_prob=None, gray_prob=0.0)
    gt = _img(24, n=4, h=48, w=48)
    key = jax.random.PRNGKey(25)
    want_lq, want_gt = jax.jit(JP.make_ffhq_degradation(jcfg))(
        key, jnp.asarray(gt))
    keys = jax.random.split(key, 12)
    n = gt.shape[0]
    kp = [_jax_kernel_params(k, prob, 1, (11, 21), (0.1, 10.0))
          for k in jax.random.split(keys[0], n)]
    k1, k2, k3 = jax.random.split(keys[2], 3)
    params = dict(
        kernel=_stack_params(kp),
        noise=dict(sigma=_t(jax.random.uniform(k1, (n, 1, 1, 1), minval=0,
                                               maxval=20) / 255.0),
                   normal=_t(jax.random.normal(k2, (n, 12, 12, 3))),
                   gray=_t(jax.random.bernoulli(k3, 0.0, (n, 1, 1, 1)))),
        down_scale=_t(jax.random.uniform(keys[4], (n,), minval=4.0,
                                         maxval=12.0)))
    lq, gt_n = TP.make_ffhq_degradation(tcfg).apply(_t(gt), params)
    _close(gt_n, want_gt)
    # lq is uint8-quantized: a value a float ulp from a level's edge may
    # round one level away
    d = np.abs(lq.numpy() - np.asarray(want_lq))
    assert d.max() <= 2 / 255 * 2 + 1e-6 and np.mean(d > 1e-5) <= 0.002


def _chain_stats(lq, gt):
    """mean |lq − gt| and the mean PSNR of lq against gt, in [0, 1]."""
    lq, gt = (np.asarray(lq) + 1) / 2, (np.asarray(gt) + 1) / 2
    mse = np.mean((lq - gt) ** 2, axis=(1, 2, 3))
    return (float(np.mean(np.abs(lq - gt))),
            float(np.mean(10 * np.log10(1.0 / np.maximum(mse, 1e-12)))))


def test_ffhq_degradation_statistics_match_jax():
    """The production chain (every kernel type, JPEG, jitters, gray) on 192
    images of 32²: the port's own draws against JAX's, mean |lq − gt|
    within 15% and mean PSNR within 0.6 dB of JAX's; the type shares
    within 0.07 of kernel_prob."""
    n, reps = 64, 3
    jcfg, tcfg = _ffhq_cfg()
    rng = np.random.default_rng(26)
    base = cv2.resize(rng.random((8, 8, 3)).astype(np.float32), (32, 32),
                      interpolation=cv2.INTER_CUBIC)
    gt = np.clip(base[None] + 0.1 * rng.standard_normal(
        (n, 32, 32, 3)).astype(np.float32), 0, 1)
    jdeg = jax.jit(JP.make_ffhq_degradation(jcfg))
    tdeg = TP.make_ffhq_degradation(tcfg)
    g = torch.Generator().manual_seed(0)
    j_stats, t_stats, types = [], [], []
    for r in range(reps):
        j_stats.append(_chain_stats(*jdeg(jax.random.PRNGKey(r),
                                          jnp.asarray(gt))))
        p = tdeg.sample(g, n, 32, 32)
        types.append(p["kernel"]["type_idx"].numpy())
        lq, gtn = tdeg.apply(_t(gt), p)
        assert lq.shape == gtn.shape == gt.shape
        assert torch.isfinite(lq).all()
        t_stats.append(_chain_stats(lq, gtn))
    (jl1, jpsnr), (tl1, tpsnr) = np.mean(j_stats, 0), np.mean(t_stats, 0)
    assert abs(tl1 - jl1) <= 0.15 * jl1, (tl1, jl1)
    assert abs(tpsnr - jpsnr) <= 0.6, (tpsnr, jpsnr)
    share = np.bincount(np.concatenate(types), minlength=7) / (n * reps)
    np.testing.assert_allclose(share, tcfg.kernel_prob, atol=0.07)


# -------------------------------------------------- dataset and loader


def _dataset_opt(root):
    return dict(type="FFHQDegradationDataset", name="t", phase="train",
                dataroot_gt=str(root), io_backend={"type": "disk"},
                input_width=32, input_height=24, batch_size_per_gpu=2,
                num_worker_per_gpu=1, dataset_enlarge_ratio=2,
                kernel_list=["iso", "aniso"], kernel_prob=[0.5, 0.5],
                noise_range=[0, 20], jpeg_range=[30, 100],
                color_jitter_prob=0.3, gray_prob=0.01)


def test_dataset_and_loader_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(27)
    os.makedirs(tmp_path / "sub")
    for i, name in enumerate(["a.png", "b.jpg", "sub/c.png", "d.png"]):
        cv2.imwrite(str(tmp_path / name),
                    (rng.random((30 + i, 40, 3)) * 255).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("x")
    opt = _dataset_opt(tmp_path)
    port = build_dataset(opt)
    ref = JaxFFHQ({k: v for k, v in opt.items() if k != "type"})
    assert port.paths == ref.paths and len(port) == 4
    for i in range(4):
        a, b = port[i], ref[i]
        assert a["gt_path"] == b["gt_path"]
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert a["gt"].shape == (24, 32, 3)
    # the degradation config each side derives from the options
    monkeypatch.setattr(jax_datasets, "make_ffhq_degradation", lambda c: c)
    want_cfg = ref.device_pipeline()
    got_cfg = port.device_pipeline().cfg
    assert {f: getattr(got_cfg, f) for f in got_cfg.__dataclass_fields__} \
        == {f: getattr(want_cfg, f) for f in want_cfg.__dataclass_fields__}
    loader = build_dataloader(port, opt, seed=0)
    loader.set_epoch(3)
    sampler = JaxSampler(4, 1, 0, 2)
    sampler.set_epoch(3)
    np.testing.assert_array_equal(loader.sampler.indices(),
                                  sampler.indices())
    batches = list(loader)
    assert len(batches) == len(loader) == 4
    assert batches[0]["gt"].shape == (2, 24, 32, 3)
    want = np.stack([port[int(i)]["gt"] for i in sampler.indices()[:2]])
    np.testing.assert_array_equal(batches[0]["gt"], want)


def test_dataset_rejects_unported_options(tmp_path):
    """crop_components is ported (tests/test_torch_gfpgan_component.py);
    with use_hflip it is refused, since the boxes would not follow the
    flip. An unknown io_backend is refused (lmdb, pak and memcached are
    ported: tests/test_torch_io.py)."""
    opt = _dataset_opt(tmp_path)
    np.savez(tmp_path / "boxes.npz", boxes=np.zeros((1, 10, 4), np.float32))
    with pytest.raises(ValueError, match="use_hflip"):
        build_dataset(dict(opt, crop_components=True, use_hflip=True,
                           component_path=str(tmp_path / "boxes.npz")))
    with pytest.raises(ValueError, match="unsupported file backend"):
        build_dataset(dict(opt, io_backend={"type": "s3"}))
