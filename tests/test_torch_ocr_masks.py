"""The port's occlusion masks and `OCRDegradationDataset` against the JAX
package on the CPU.

Each apply half runs at the parameters JAX's keys draw (the uniforms and
integers taken from the same `jax.random` splits JAX's functions make) and
must give JAX's masks and masked images bit for bit; the brush-stroke bank
is host numpy and bit-equal. The sample halves are held by their
frequencies within 5 binomial standard deviations. A dataset item equals
JAX's (the aspect-preserving pad on a white canvas, the plain resize, RGB),
and the device pipeline fills the masked pixels with white in normalized
space.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import build_dataset as jax_build_dataset
from image_restoration_tpu.data import masks as jm
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.data import masks as tm
from image_restoration_tpu_torch.data.pipelines import OCRDegradation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_rect_draws(key, n, num_rects=3):
    keys = jax.random.split(key, 4)
    return {k: _t(jax.random.uniform(keys[i], (n, 1, 1, num_rects)))
            for i, k in enumerate(("y0", "x0", "h", "w"))}


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (3, 24, 56, 3)])
def test_rect_and_half_masks_at_jax_draws(shape):
    key = jax.random.PRNGKey(7)
    n, h, w = shape[:3]
    want = np.asarray(jm.random_rect_masks(key, shape))
    got = tm.rect_masks(_jax_rect_draws(key, n), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    side = jax.random.randint(key, (n, 1, 1, 1), 0, 4)
    np.testing.assert_array_equal(tm.half_mask(_t(side), h, w).numpy(),
                                  np.asarray(jm.half_mask(key, shape)))


def test_irregular_bank_bit_equal():
    for size, num, seed in ((32, 8, 0), (48, 4, 3)):
        np.testing.assert_array_equal(
            tm.build_irregular_mask_bank(size, num, seed),
            jm.build_irregular_mask_bank(size, num, seed))


@pytest.mark.parametrize("mask_prob", [1.0, 0.5])
def test_apply_random_mask_at_jax_draws(mask_prob):
    bank = jm.build_irregular_mask_bank(16, num=5)
    n = 6
    img = np.random.default_rng(0).random((n, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_out, want_mask = jm.apply_random_mask(key, jnp.asarray(img),
                                               jnp.asarray(bank), mask_prob,
                                               fill=0.7)
    k0, k1, k2, k3, k4 = jax.random.split(key, 5)
    p = dict(
        do=_t(jax.random.bernoulli(k0, mask_prob, (n, 1, 1, 1))).reshape(n),
        rect=_jax_rect_draws(k1, n),
        side=_t(jax.random.randint(k2, (n, 1, 1, 1), 0, 4)).reshape(n),
        idx=_t(jax.random.randint(k3, (n,), 0, bank.shape[0])).long(),
        kind=_t(jax.random.randint(k4, (n, 1, 1, 1), 0, 3)).reshape(n))
    out, mask = tm.apply_random_mask(_t(img), _t(bank), p, fill=0.7)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))


def _within(count, n, prob):
    return abs(count - n * prob) <= 5 * np.sqrt(n * prob * (1 - prob))


def test_sample_frequencies():
    n = 6000
    p = tm.sample_random_mask(torch.Generator().manual_seed(0), n,
                              bank_size=64, mask_prob=0.3)
    assert _within(int(p["do"].sum()), n, 0.3)
    for k in range(3):
        assert _within(int((p["kind"] == k).sum()), n, 1 / 3)
    for s in range(4):
        assert _within(int((p["side"] == s).sum()), n, 1 / 4)
    assert int(p["idx"].min()) == 0 and int(p["idx"].max()) == 63
    for v in p["rect"].values():
        assert v.shape == (n, 1, 1, 3) and 0 <= float(v.min()) < 0.01
        assert abs(float(v.mean()) - 0.5) < 0.02
    # the whole mask: the masked share is do · the kinds' mean coverage
    img = torch.zeros(n, 16, 16, 1)
    bank = torch.from_numpy(tm.build_irregular_mask_bank(16, 64))
    _, mask = tm.apply_random_mask(img, bank, p)
    per = mask.mean(dim=(1, 2, 3))
    assert bool((per[~p["do"]] == 0).all())
    np.testing.assert_allclose(
        float(per[(p["kind"] == 2) & p["do"]].mean()), 0.5)


def _ocr_opt(root, **kw):
    return dict(dict(
        type="OCRDegradationDataset", dataroot_gt=str(root),
        io_backend={"type": "disk"}, input_width=64, input_height=32,
        kernel_list=["iso", "aniso"], kernel_prob=[0.5, 0.5],
        blur_sigma=[0.1, 3], blur_kernel_size=7, downsample_range=[2, 4],
        noise_range=[0, 10], jpeg_range=[60, 95], random_mask=True,
        mask_prob=1.0, mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]), **kw)


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocr_gt")
    rng = np.random.default_rng(0)
    for i, hw in enumerate([(20, 50), (40, 30), (32, 64)]):
        cv2.imwrite(str(root / f"{i}.png"),
                    (rng.random((*hw, 3)) * 255).astype(np.uint8))
    return root


@pytest.mark.parametrize("pad_input", [True, False])
def test_ocr_items_equal_jax(plates, pad_input):
    opt = _ocr_opt(plates, pad_input=pad_input)
    ours, theirs = build_dataset(opt), jax_build_dataset(opt)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert a["gt"].shape == (32, 64, 3) and a["gt"].dtype == np.float32
        np.testing.assert_array_equal(a["gt"], b["gt"])
    if pad_input:  # a 20×50 plate: white bars above and below
        assert (ours[0]["gt"][0] == 1.0).all()


def test_ocr_device_pipeline_fills_white(plates):
    ds = build_dataset(_ocr_opt(plates, pad_input=True))
    degrade = ds.device_pipeline()
    assert isinstance(degrade, OCRDegradation) and degrade.fill == 1.0
    gt = torch.from_numpy(np.stack([ds[i]["gt"] for i in range(3)]))
    gen = torch.Generator().manual_seed(0)
    p = degrade.sample(gen, 3, 32, 64)
    lq, gt_n = degrade.apply(gt, p)
    assert lq.shape == gt.shape and bool(torch.isfinite(lq).all())
    np.testing.assert_allclose(gt_n.numpy(), (gt.numpy() - 0.5) / 0.5)
    bank = torch.from_numpy(tm.build_irregular_mask_bank(64)[:, :32])
    _, mask = tm.apply_random_mask(torch.zeros(3, 32, 64, 1), bank,
                                   p["mask"])
    m = mask[..., 0] > 0
    assert bool(m.any()) and bool((lq[m] == 1.0).all())
    # the base chain alone where nothing is masked
    base_lq, _ = degrade.base.apply(gt, p["base"])
    torch.testing.assert_close(lq[~m], base_lq[~m], rtol=0, atol=0)
    plain = build_dataset(_ocr_opt(plates, random_mask=False))
    assert not isinstance(plain.device_pipeline(), OCRDegradation)


def test_non_square_plate_masks_finding():
    """JAX's OCR pipeline builds an input_height² bank
    (data/datasets.py:212), which cannot mask a 32×64 plate; the port's
    max(H, W)² bank cropped to the plate can, and is JAX's bank when the
    plate is square."""
    bank = jnp.asarray(jm.build_irregular_mask_bank(32, num=4))
    with pytest.raises(ValueError, match="broadcast"):
        jm.apply_random_mask(jax.random.PRNGKey(0), jnp.zeros((2, 32, 64, 3)),
                             bank, 1.0)
    p = tm.sample_random_mask(torch.Generator().manual_seed(1), 2, 4, 1.0)
    crop = torch.from_numpy(tm.build_irregular_mask_bank(64, num=4)[:, :32])
    out, mask = tm.apply_random_mask(torch.zeros(2, 32, 64, 3), crop, p)
    assert out.shape == (2, 32, 64, 3) and float(mask.max()) == 1.0
