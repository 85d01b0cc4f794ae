"""The ×4 output's way back to the host in `EngineRestorer`
(`serve/engine_restorer.py` `_to_host`).

On the CPU the output already lives in host memory: the path is the
`.cpu().numpy()` it always was, counted as `engine_restorer.pageable_out`.
On the card it lands in page-locked memory from PyTorch's caching host
allocator, counted as `engine_restorer.pinned_out`. Either way each
returned array owns its memory: no later call writes into it. The card-only
tests (marker `cuda`) run the engine at its serving widths on a 2048×1024
photo (8 tiles, one whole engine call, a contiguous output) and a 640×360
one (2 tiles, a cropped and so non-contiguous output). This file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_engine_d2h.py
"""

import collections

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.parallel.tiling import tiled_apply
from image_restoration_tpu_torch.serve import engine_restorer
from image_restoration_tpu_torch.serve.engine_restorer import EngineRestorer
from image_restoration_tpu_torch.utils import profiler

PINNED = "engine_restorer.pinned_out"
PAGEABLE = "engine_restorer.pageable_out"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counter(name):
    return profiler.snapshot()["counters"].get(name, 0)


def _photos(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _parent_path(er, img):
    """`EngineRestorer.__call__` as it was with `.cpu().numpy()` for its
    copy back: the stitched tensor's pageable copy."""
    if er.u8_io:
        fn = er.serve
    else:
        img = np.asarray(img, np.float32) / 255.0

        def fn(t):
            return er.serve(t.to(torch.bfloat16))
    x = torch.from_numpy(np.ascontiguousarray(img)).to(er.device)
    with torch.inference_mode():
        out = tiled_apply(fn, x[None], tile=er.tile, halo=er.halo,
                          scale=er.upscale, tile_batch=er.batch)[0]
        out = (out if er.u8_io else out.float()).cpu().numpy()
    if er.u8_io:
        return out
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- the CPU

@pytest.fixture(scope="module")
def cpu_engines():
    return {io: EngineRestorer.build(num_feat=8, num_conv=2, upscale=4,
                                     tile=64, halo=4, batch=8, seed=3,
                                     io=io, device="cpu")
            for io in ("u8", "bf16")}


@pytest.mark.parametrize("io", ["u8", "bf16"])
@pytest.mark.parametrize("hw", [(64, 128), (40, 100)],
                         ids=["whole_grid", "cropped"])
def test_cpu_output_is_the_parent_path_bit_for_bit(cpu_engines, io, hw):
    er = cpu_engines[io]
    img = _photos(1, *hw, seed=hw[1])[0]
    got = er(img)
    assert got.shape == (4 * hw[0], 4 * hw[1], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _parent_path(er, img))


def test_cpu_output_counts_pageable_and_never_pinned(cpu_engines):
    er = cpu_engines["u8"]
    pinned, pageable = _counter(PINNED), _counter(PAGEABLE)
    for k, img in enumerate(_photos(3, 40, 100), 1):
        er(img)
        assert _counter(PAGEABLE) == pageable + k
    assert _counter(PINNED) == pinned


def test_cpu_to_host_keeps_a_host_tensor_as_it_is():
    """No new copy on the CPU: the array is the tensor's own memory."""
    t = torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3)
    out = engine_restorer._to_host(t)
    assert np.shares_memory(out, t.numpy())
    np.testing.assert_array_equal(out, t.numpy())


def _earlier_output_survives(er, photos):
    first = er(photos[0])
    kept = first.copy()
    later = [er(img) for img in photos[1:]]
    np.testing.assert_array_equal(first, kept)
    for out in later:
        assert not np.shares_memory(first, out)


@pytest.mark.parametrize("io", ["u8", "bf16"])
def test_cpu_earlier_output_survives_later_calls(cpu_engines, io):
    _earlier_output_survives(cpu_engines[io], _photos(4, 40, 100, seed=5))


# ------------------------------------------------------------- the card

WIDE, SMALL = (1024, 2048), (360, 640)


@pytest.fixture(scope="module")
def card_engine():
    """The `/SRx4/` engine at its serving widths on the card (int8 on K2,
    tile 512, halo 8, batch 8, uint8 IO), seeded weights. Decided when
    the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned path runs only there")
    return EngineRestorer.build(num_feat=64, num_conv=32, upscale=4,
                                tile=512, halo=8, batch=8, seed=7,
                                device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [WIDE, SMALL], ids=["2048x1024", "640x360"])
def test_pinned_output_is_the_stitched_tensor_bit_for_bit(card_engine, hw,
                                                          monkeypatch):
    seen = []
    real = engine_restorer._to_host

    def spy(t):
        seen.append(t)
        return real(t)

    monkeypatch.setattr(engine_restorer, "_to_host", spy)
    got = card_engine(_photos(1, *hw, seed=hw[1])[0])
    (stitched,) = seen
    assert stitched.is_cuda
    # the small photo's output is a crop of its two tiles' grid
    assert stitched.is_contiguous() == (hw == WIDE)
    assert got.shape == (4 * hw[0], 4 * hw[1], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, stitched.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [WIDE, SMALL], ids=["2048x1024", "640x360"])
def test_pinned_earlier_output_survives_later_calls(card_engine, hw):
    pinned, pageable = _counter(PINNED), _counter(PAGEABLE)
    _earlier_output_survives(card_engine, _photos(5, *hw, seed=11))
    assert _counter(PINNED) == pinned + 5
    assert _counter(PAGEABLE) == pageable


def _host_blocks():
    """Blocks the caching host allocator has made with `cudaHostAlloc`."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


@pytest.mark.cuda
def test_pinned_host_memory_stops_growing_after_warm_up(card_engine):
    """At most 3 outputs held by the caller (4 live during a call): the
    allocator makes no block after the first few calls."""
    photos = _photos(4, *WIDE, seed=13)
    held = collections.deque(maxlen=3)
    for i in range(4):
        held.append(card_engine(photos[i % 4]))
    warm = _host_blocks()
    for i in range(12):
        held.append(card_engine(photos[i % 4]))
    assert _host_blocks() == warm
