"""The port's SR data layer against the JAX package: the host transforms,
the SR datasets, and the Real-ESRGAN second-order degradation.

Transforms and datasets draw from Python's `random` and numpy's global
generator, so under one seed both sides give equal arrays. Random streams
of the degradation cannot match across frameworks, so each of its stages
is held at the parameters JAX's keys draw, exactly as the JAX function
draws them (its `_blur_stage` and `_noise_stage` are taken from the
chain's closure), ≤1e-5 absolute on values in [0, 1]; JPEG by
`test_torch_train_data._jpeg_close`; the chain by statistics.
"""

import math
import os
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import datasets as jax_datasets
from image_restoration_tpu.data import degradations as JD
from image_restoration_tpu.data import pipelines as JP
from image_restoration_tpu.data import transforms as JT
from image_restoration_tpu.ops.filter2d import filter2d as jfilter2d
from image_restoration_tpu.ops.resize import resize as jresize
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.data import pipelines as TP
from image_restoration_tpu_torch.data import transforms as TT
from image_restoration_tpu_torch.ops.filter2d import filter2d
from image_restoration_tpu_torch.utils.registry import DATASET_REGISTRY
from test_torch_train_data import _jpeg_close

ATOL = 1e-5
KINDS = ("iso", "aniso", "generalized_iso", "generalized_aniso",
         "plateau_iso", "plateau_aniso")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _img(seed, n=4, h=24, w=28):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(
        np.float32)


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


# --------------------------------------------------------- transforms


def test_transforms_match_jax_under_one_seed():
    """mod_crop, paired_random_crop (one image and lists), augment (images,
    flows, status) and img_rotate."""
    rng = np.random.default_rng(0)
    gt = rng.random((40, 36, 3)).astype(np.float32)
    lq = rng.random((10, 9, 3)).astype(np.float32)
    flow = rng.standard_normal((10, 9, 2)).astype(np.float32)
    for scale in (3, 4, 5):
        np.testing.assert_array_equal(TT.mod_crop(gt, scale),
                                      JT.mod_crop(gt, scale))
    with pytest.raises(ValueError):
        TT.mod_crop(gt[None], 4)
    for seed in range(6):
        calls = [
            lambda m: m.paired_random_crop(gt, lq, 16, 4),
            lambda m: m.paired_random_crop([gt, gt], [lq, lq], 20, 4),
            lambda m: m.augment([gt, lq], True, True, return_status=True),
            lambda m: m.augment(lq, True, True, flows=[flow, flow]),
        ]
        for call in calls:
            got = _seeded(seed, lambda: call(TT))
            want = _seeded(seed, lambda: call(JT))
            for g, w in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="Scale mismatches"):
        TT.paired_random_crop(gt, lq[:5], 16, 4)
    np.testing.assert_array_equal(TT.img_rotate(gt, 30.0),
                                  JT.img_rotate(gt, 30.0))


# ----------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """GT images of odd sizes (one smaller than gt_size), ×4 LQ ones named
    `{stem}x4`, and a meta-info file naming two of them."""
    root = tmp_path_factory.mktemp("sr_data")
    rng = np.random.default_rng(1)
    for d in ("gt", "lq"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(64, 72), (40, 48), (80, 64)]):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"im{i}.png"), img)
        cv2.imwrite(str(root / "lq" / f"im{i}x4.png"), cv2.resize(
            img, (w // 4, h // 4), interpolation=cv2.INTER_AREA))
    (root / "meta.txt").write_text("im2.png (80,64,3)\nim0.png (64,72,3)\n")
    return root


def _pair_datasets(opt):
    port = build_dataset(opt)
    ref = getattr(jax_datasets, opt["type"])(
        {k: v for k, v in opt.items() if k != "type"})
    return port, ref


@pytest.mark.parametrize("case", [
    "realesrgan", "realsr_alias", "paired_train", "paired_meta_norm",
    "single"])
def test_sr_datasets_match_jax_under_one_seed(folders, case):
    """Each sample equal under one seed: the random crops (numpy's
    generator), the flips (Python's `random`), the LQ names from
    filename_tmpl or a meta_info_file, the normalization."""
    r = str(folders)
    opts = {
        "realesrgan": dict(type="RealESRGANDataset", dataroot_gt=f"{r}/gt",
                           gt_size=48, use_hflip=True, use_rot=True),
        "realsr_alias": dict(type="RealSRDegradationDataset",
                             dataroot_gt=f"{r}/gt", gt_size=32),
        "paired_train": dict(type="PairedImageDataset", phase="train",
                             dataroot_gt=f"{r}/gt", dataroot_lq=f"{r}/lq",
                             filename_tmpl="{}x4", scale=4, gt_size=32),
        "paired_meta_norm": dict(type="PairedImageDataset", phase="val",
                                 dataroot_gt=f"{r}/gt",
                                 dataroot_lq=f"{r}/lq",
                                 filename_tmpl="{}x4",
                                 meta_info_file=f"{r}/meta.txt",
                                 mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
        "single": dict(type="SingleImageDataset", dataroot_lq=f"{r}/lq",
                       mean=[0.4, 0.5, 0.6], std=[0.2, 0.2, 0.2]),
    }
    port, ref = _pair_datasets(opts[case])
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        for seed in (0, 1):
            a = _seeded(seed, lambda: port[i])
            b = _seeded(seed, lambda: ref[i])
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    assert case != "realesrgan" or port[0]["gt"].shape == (48, 48, 3)


def test_dataset_registry_names():
    import image_restoration_tpu_torch.data.datasets  # noqa: F401
    for name in ("RealESRGANDataset", "RealSRDegradationDataset",
                 "PairedImageDataset", "SingleImageDataset",
                 "FFHQDegradationDataset"):
        assert name in DATASET_REGISTRY


def test_realesrgan_config_matches_jax(folders, monkeypatch):
    """The dataclass's defaults, and the config each side derives from a
    dataset's options (lists as tuples)."""
    j, t = JP.RealESRGANDegradationConfig(), TP.RealESRGANDegradationConfig()
    assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
        {f: getattr(t, f) for f in t.__dataclass_fields__}
    opt = dict(type="RealESRGANDataset", dataroot_gt=f"{folders}/gt",
               gt_size=48, sinc_prob=0.3, kernel_prob=[0.5, 0.5, 0, 0, 0, 0],
               resize_range=[0.5, 1.2], scale=2)
    port, ref = _pair_datasets(opt)
    monkeypatch.setattr(jax_datasets, "make_realesrgan_degradation",
                        lambda c: c)
    want = ref.device_pipeline()
    got = port.device_pipeline().cfg
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert got.scale == 2 and got.kernel_prob == (0.5, 0.5, 0, 0, 0, 0)


# ------------------------------------------- the chain's stages, pinned


def _jax_closure(cfg):
    """JAX's `_blur_stage` and `_noise_stage`, from the chain's closure."""
    degrade = JP.make_realesrgan_degradation(cfg)
    cells = dict(zip(degrade.__code__.co_freevars,
                     (c.cell_contents for c in degrade.__closure__)))
    return cells["_blur_stage"], cells["_noise_stage"]


def _u(key, shape, lo, hi):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _jax_kernel_params(key, prob, size, sigma, betag, betap):
    """`random_mixed_kernel`'s draws from `key` (`degradations.py:
    141-170`) at one kernel size."""
    keys = jax.random.split(key, 8)
    return dict(
        type_idx=int(jax.random.categorical(
            keys[0], jnp.log(jnp.asarray(prob, jnp.float32) + 1e-12))),
        sig_x=float(_u(keys[1], (), *sigma)),
        sig_y=float(_u(keys[2], (), *sigma)),
        theta=float(_u(keys[3], (), -math.pi, math.pi)),
        betag=float(_u(keys[4], (), *betag)),
        betap=float(_u(keys[5], (), *betap)),
        ksize=size, horizontal=bool(jax.random.bernoulli(keys[7])),
        bank_idx=0)


def _stack(ps):
    dtypes = dict(type_idx=torch.long, ksize=torch.long,
                  horizontal=torch.bool, bank_idx=torch.long)
    return {k: torch.tensor([p[k] for p in ps],
                            dtype=dtypes.get(k, torch.float32))
            for k in ps[0]}


def test_blur_stage_matches_jax():
    """All six kernel families (their draw by kernel_prob) and the sinc
    replacement, at JAX's draws, through JAX's own `_blur_stage`."""
    cfg = JP.RealESRGANDegradationConfig()
    blur, _ = _jax_closure(cfg)
    x = _img(2, n=12)
    key = jax.random.PRNGKey(3)
    prob = (0.2, 0.2, 0.15, 0.15, 0.15, 0.15)
    args = (KINDS, prob, (0.2, 3.0), (0.5, 4.0), (1.0, 2.0), 0.4)
    want = jax.jit(lambda k, im: blur(k, im, *args))(key, jnp.asarray(x))
    k1, k2, k3 = jax.random.split(key, 3)
    kp = [_jax_kernel_params(k, prob, 21, *args[2:5])
          for k in jax.random.split(k1, 12)]
    p = dict(kernel=_stack(kp),
             use_sinc=_t(jax.random.bernoulli(k2, 0.4, (12, 1, 1)))[:, 0, 0],
             sinc_idx=_t(jax.random.randint(k3, (12,), 0, 64)).long())
    assert len({q["type_idx"] for q in kp}) >= 4
    assert 0 < int(p["use_sinc"].sum()) < 12
    deg = TP.make_realesrgan_degradation(TP.RealESRGANDegradationConfig())
    _close(deg.blur_stage(_t(x), p, KINDS), want)


@pytest.mark.parametrize("probs,ranges", [
    ((0.2, 0.7, 0.1), (0.15, 1.5)), ((0.3, 0.4, 0.3), (0.3, 1.2))])
def test_virtual_rescale_matches_jax(probs, ranges):
    x = _img(4, n=8, h=32, w=24)
    key = jax.random.PRNGKey(5)
    want = JP._virtual_rescale(key, jnp.asarray(x), probs, ranges)
    k1, k2 = jax.random.split(key)
    p = dict(mode=_t(jax.random.categorical(
        k1, jnp.log(jnp.asarray(probs) + 1e-12), shape=(8,))).long(),
        scale=_t(_u(k2, (8,), *ranges)))
    assert int((p["mode"] == 1).sum()) > 0
    _close(TP.virtual_rescale(_t(x), p), want)


def test_noise_stage_matches_jax():
    """Gaussian where drawn, Poisson elsewhere (gray draws on both), the
    Poisson counts JAX's; through JAX's own `_noise_stage`."""
    _, noise = _jax_closure(JP.RealESRGANDegradationConfig())
    x = np.round(_img(6, n=8) * 255) / 255
    key = jax.random.PRNGKey(7)
    args = (0.5, (1.0, 30.0), (0.05, 3.0), 0.4)
    want = noise(key, jnp.asarray(x), *args)
    n = x.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    ga, gb, gc = jax.random.split(k2, 3)
    pa, pb, pc = jax.random.split(k3, 3)
    gray = jax.random.bernoulli(pc, 0.4, (n, 1, 1, 1))
    src = jnp.where(gray, jnp.mean(jnp.asarray(x), -1, keepdims=True),
                    jnp.asarray(x))
    p = dict(
        use_gauss=_t(jax.random.bernoulli(k1, 0.5, (n, 1, 1, 1))),
        gauss=dict(sigma=_t(_u(ga, (n, 1, 1, 1), 1.0, 30.0) / 255.0),
                   normal=_t(jax.random.normal(gb, x.shape)),
                   gray=_t(jax.random.bernoulli(gc, 0.4, (n, 1, 1, 1)))),
        poisson=dict(scale=_t(_u(pa, (n, 1, 1, 1), 0.05, 3.0)),
                     gray=_t(gray),
                     counts=_t(jax.random.poisson(
                         pb, jnp.clip(src, 0, 1) * 256.0)).float()))
    assert 0 < int(p["use_gauss"].sum()) < n
    _close(TP.RealESRGANDegradation.noise_stage(_t(x), p), want)


def test_noise_stage_draws_poisson_once_and_replays():
    """Without counts, apply draws them from its generator and keeps them
    in the parameters, so a second apply reproduces the first."""
    deg = TP.make_realesrgan_degradation(TP.RealESRGANDegradationConfig())
    x = _t(_img(8, h=32, w=32))
    p = deg.sample(torch.Generator().manual_seed(0), 4, 32, 32)
    lq1, _ = deg.apply(x, p, torch.Generator().manual_seed(1))
    assert "counts" in p["noise1"]["poisson"]
    lq2, _ = deg.apply(x, p)
    torch.testing.assert_close(lq1, lq2, rtol=0, atol=0)
    assert lq1.shape == (4, 8, 8, 3)


def test_final_stage_matches_jax():
    """[bilinear resize to 1/scale + sinc or identity] and JPEG in the
    drawn order, then the 8-bit round trip, against the JAX chain's last
    lines (`pipelines.py:283-300`) at its draws."""
    cfg = JP.RealESRGANDegradationConfig()
    x = _img(9, n=6, h=64, w=64)
    kf, ki, kq, ko = jax.random.split(jax.random.PRNGKey(10), 4)
    n = x.shape[0]
    bank = jnp.asarray(JD.sinc_kernel_bank(21))
    final_sinc = jax.random.bernoulli(kf, 0.8, (n, 1, 1))
    idx = jax.random.randint(ki, (n,), 0, bank.shape[0])
    ident = jnp.zeros((21, 21)).at[10, 10].set(1.0)
    fk = jnp.where(final_sinc, bank[idx], ident)
    order = jax.random.bernoulli(ko, 0.5, (n, 1, 1, 1))
    xj = jnp.asarray(x)
    a = JD.add_jpeg_compression(
        kq, jfilter2d(jresize(xj, (16, 16), "bilinear"), fk), cfg.jpeg_range2)
    b = jfilter2d(jresize(JD.add_jpeg_compression(kq, xj, cfg.jpeg_range2),
                          (16, 16), "bilinear"), fk)
    want = jnp.clip(jnp.round(jnp.where(order, a, b) * 255), 0, 255) / 255
    p = dict(final_sinc=_t(final_sinc)[:, 0, 0], final_sinc_idx=_t(idx)
             .long(), jpeg2=_t(_u(kq, (n,), *cfg.jpeg_range2)),
             resize_first=_t(order))
    assert 0 < int(p["resize_first"].sum()) < n
    deg = TP.make_realesrgan_degradation(TP.RealESRGANDegradationConfig())
    _jpeg_close(deg.final_stage(_t(x), p).numpy(), want)


def test_filter2d_reflects_past_a_small_image():
    """A 21-tap kernel on a 6×8 image: numpy's reflect padding reflects
    again past the far edge (as JAX's filter2d pads); the port's reflect
    pad used to refuse a pad as large as the image."""
    x = _img(11, n=2, h=6, w=8)
    k = np.random.default_rng(12).random((2, 21, 21)).astype(np.float32)
    k /= k.sum(axis=(1, 2), keepdims=True)
    _close(filter2d(_t(x), _t(k)), jfilter2d(jnp.asarray(x), jnp.asarray(k)))


# ------------------------------------------------------ the chain


def _chain_stats(lq, gt):
    """mean |lq − area(gt)| and mean PSNR of lq against the area-resized
    GT."""
    lq, gt = np.asarray(lq), np.asarray(gt)
    n, h, w, _ = lq.shape
    ref = np.stack([cv2.resize(g, (w, h), interpolation=cv2.INTER_AREA)
                    for g in gt])
    mse = np.mean((lq - ref) ** 2, axis=(1, 2, 3))
    return (float(np.mean(np.abs(lq - ref))),
            float(np.mean(10 * np.log10(1.0 / np.maximum(mse, 1e-12)))))


def test_realesrgan_chain_statistics_match_jax():
    """The default chain on 192 images of 48²: the port's own draws against
    JAX's, mean |lq − GT↓| within 10% and mean PSNR within 1.2 dB (about
    three standard deviations of the difference of two such means); lq on
    8-bit levels at 1/4 the size, gt returned unchanged."""
    n, reps = 64, 3
    rng = np.random.default_rng(26)
    base = cv2.resize(rng.random((8, 8, 3)).astype(np.float32), (48, 48),
                      interpolation=cv2.INTER_CUBIC)
    gt = np.clip(base[None] + 0.1 * rng.standard_normal(
        (n, 48, 48, 3)).astype(np.float32), 0, 1)
    jdeg = jax.jit(JP.make_realesrgan_degradation(
        JP.RealESRGANDegradationConfig()))
    tdeg = TP.make_realesrgan_degradation(TP.RealESRGANDegradationConfig())
    g = torch.Generator().manual_seed(0)
    j_stats, t_stats = [], []
    for r in range(reps):
        j_stats.append(_chain_stats(*jdeg(jax.random.PRNGKey(r),
                                          jnp.asarray(gt))))
        lq, gt_out = tdeg(g, _t(gt))
        assert lq.shape == (n, 12, 12, 3) and torch.equal(gt_out, _t(gt))
        np.testing.assert_array_equal(lq * 255, torch.round(lq * 255))
        t_stats.append(_chain_stats(lq, gt))
    (jl1, jpsnr), (tl1, tpsnr) = np.mean(j_stats, 0), np.mean(t_stats, 0)
    assert abs(tl1 - jl1) <= 0.1 * jl1, (tl1, jl1)
    assert abs(tpsnr - jpsnr) <= 1.2, (tpsnr, jpsnr)
