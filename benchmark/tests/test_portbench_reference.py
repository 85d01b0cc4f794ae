"""Each reference agrees with the port at a narrow width on the CPU, both
sides given the same seeded weights through a run's own paths
(`cell.build` and `cell.reference`)."""

import numpy as np
import torch

from benchmark.harness import cell
from benchmark.harness.weights import smooth_images

from .tiny import tiny_spec


def test_gfpgan_reference_within_one_level_of_the_port():
    spec = tiny_spec("ocr256.batch32")
    dev = torch.device("cpu")
    params, restorer = cell.build(spec, 2 ** 33 + 1, dev)
    ref = cell.reference(spec, params, 2 ** 33 + 1, dev)
    x = smooth_images(3, 32, 32, 5, "pool", dev).numpy()
    got, want = restorer.restore_batch_u8(x), ref.restore_batch_u8(x)
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == (3, 32, 32, 3)
    assert d.max() <= 1 and d.mean() < 0.01
    assert 0.05 < np.mean((got > 0) & (got < 255))  # not all clipped


def test_gfpgan_reference_at_full_width_one_image():
    """The published widths, one 256² image: the plain forward and the
    port agree within one level (float32 on both sides here)."""
    spec = cell.Spec("ocr256.batch32")
    dev = torch.device("cpu")
    params, restorer = cell.build(spec, 7, dev)
    ref = cell.reference(spec, params, 7, dev)
    x = smooth_images(1, 256, 256, 7, "pool", dev).numpy()
    d = np.abs(restorer.restore_batch_u8(x).astype(int)
               - ref.restore_batch_u8(x).astype(int))
    assert d.max() <= 1 and d.mean() < 0.01


def test_sr_reference_bit_equal_to_the_engine():
    spec = tiny_spec("srx4.wide")
    dev = torch.device("cpu")
    for seed in (3, 2 ** 40 + 9):
        params, engine = cell.build(spec, seed, dev)
        ref = cell.reference(spec, params, seed, dev)
        img = smooth_images(1, 70, 100, seed, "pool", dev)[0].numpy()
        got, want = engine(img), ref(img)
        assert got.shape == want.shape == (280, 400, 3)
        assert np.array_equal(got, want)


def test_controls_differ_from_the_reference():
    """The lower precision that the controls run is really lower: bfloat16
    moves the restore, int4 the SR engine."""
    dev = torch.device("cpu")
    spec = tiny_spec("ocr256.batch32")
    params, _ = cell.build(spec, 11, dev)
    x = smooth_images(2, 32, 32, 11, "pool", dev).numpy()
    a = cell.reference(spec, params, 11, dev).restore_batch_u8(x)
    b = cell.reference(spec, params, 11, dev,
                           control=True).restore_batch_u8(x)
    assert np.abs(a.astype(int) - b.astype(int)).mean() > 0.05
    spec = tiny_spec("srx4.small")
    params, _ = cell.build(spec, 11, dev)
    img = smooth_images(1, 40, 40, 11, "pool", dev)[0].numpy()
    a = cell.reference(spec, params, 11, dev)(img)
    b = cell.reference(spec, params, 11, dev, control=True)(img)
    assert np.abs(a.astype(int) - b.astype(int)).mean() > 1.0
