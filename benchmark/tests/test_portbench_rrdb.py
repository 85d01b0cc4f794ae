"""`rrdb_x4.wide`: `correct` comes out false when the timed path is broken
underneath and when the int4 control stands in the program's place, its
frozen counts counted again, and its per-layer readers.

The CPU tests cut the cell to 4 blocks at the published widths (64/32),
tile 32, halo 4, batch 2, on small photos (at 2 the int4 control's gap,
which grows with depth, lies near the cell's limit). The card-only tests
(marker `cuda`) run it at its own size:

    python -m pytest -m cuda benchmark/tests/test_portbench_rrdb.py
"""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cell, readings
from benchmark.harness.weights import draw_params

from .test_portbench_faults import altered_answer, half_batch

WORKLOAD = "rrdb_x4.wide"
SEED = 2 ** 34 + 23
CUT = dict(network=dict(num_block=4), engine=dict(tile=32, halo=4, batch=2),
           calibration=dict(height=32, width=32),
           traffic=dict(pool=3, height=40, width=70, grid_tile=32,
                        check_block=64, warmup_calls=1))


def cut_spec() -> cell.Spec:
    spec = cell.Spec(WORKLOAD)
    for key, value in CUT.items():
        (spec.traffic if key == "traffic" else spec.config[key]).update(value)
    return spec


def _run(spec, substitute=None, device="cpu", seconds=0.6, trace=False):
    return cell.run(spec, SEED, seconds, trace, device, time.monotonic(),
                    substitute=substitute)


@pytest.fixture
def recorder():
    from image_restoration_tpu_torch.utils import profiler

    profiler.reset()
    return profiler


def test_a_sound_run_is_correct():
    out = _run(cut_spec())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [half_batch, altered_answer],
                         ids=["half_batch", "altered_answer"])
def test_a_broken_timed_path_is_not_correct(fault):
    out = _run(cut_spec(), substitute=fault)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    spec = cut_spec()
    out = _run(spec, substitute=readings.control(spec, SEED, "cpu"))
    assert not out["correct"], out["checks"]


def test_ops_per_tile_are_the_mac_sums_times_the_area():
    """At the cell's size the frozen operations are 2 · the per-pixel MAC
    sums times the tile's area; at a small tile the flop counter over the
    reference's float forward (conv_k over the concatenation) counts their
    sum."""
    spec = cell.Spec(WORKLOAD)
    net, eng, c = (spec.config["network"], spec.config["engine"],
                   spec.counts)
    area = (eng["tile"] + 2 * eng["halo"]) ** 2
    assert area == 544 * 544
    assert c.int8_macs_per_pixel(net) == 23 * 3 * 9 * (
        64 * 192 + 32 * 160 + 32 * 128 + 32 * 96 + 32 * 64) == 16_533_504
    assert c.bf16_macs_per_pixel(net) == 9 * (
        3 * 64 + 64 * 64 + 4 * 64 * 64 + 16 * 64 * 64 * 2
        + 16 * 64 * 3) == 1_393_344
    assert c.int8_ops_per_tile(net, eng) == 2 * 16_533_504 * area
    assert c.bf16_flops_per_tile(net, eng) == 2 * 1_393_344 * area
    small = dict(net, num_block=2)
    p = draw_params(spec.reference.schema(small), 0, "cpu")
    with FlopCounterMode(display=False) as fc:
        spec.reference.forward(p, small, torch.zeros(1, 12, 12, 3))
    e12 = dict(tile=8, halo=2)
    assert fc.get_total_flops() == (c.int8_ops_per_tile(small, e12)
                                    + c.bf16_flops_per_tile(small, e12))


def test_k2_least_time_is_the_larger_bound_of_each_launch():
    """PR 4's figure: one 528² image through 23 blocks, 8.4573 ms by bytes
    (PERF.md, the K2 row); a call of 8 tiles of 544² reads every stage's
    weights once."""
    spec = cell.Spec(WORKLOAD)
    net, c = spec.config["network"], spec.counts
    one = c.k2_least_s(net, dict(tile=496, halo=16), 1, 1, cell.PEAKS)
    assert abs(one * 1e3 - 8.4573) < 1e-3
    eng = spec.config["engine"]
    eight = c.k2_least_s(net, eng, 8, 1, cell.PEAKS)
    two = c.k2_least_s(net, eng, 16, 2, cell.PEAKS)
    assert two == pytest.approx(2 * eight)


def test_traced_readers_on_the_cpu(recorder):
    """A traced run at the cut: the body's span reads and the window is
    all idle; the shares of busy device time need a device and read
    nothing."""
    spec = cut_spec()
    spec.traffic["trace_seconds"] = 0.3
    out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["rrdb_body_ms"]["value"] > 0
    assert m["idle.rrdb"]["value"] == 100.0
    for name in ("rrdb_mfu", "rrdb_k2_roofline", "rrdb_k2_share",
                 "rrdb_glue_share"):
        assert name not in m


def test_readers_read_nothing_without_the_programs_counter(recorder):
    """The control has no engine, no spans and no counters: the program
    readers leave their metrics out and do not raise."""
    spec = cut_spec()
    spec.traffic["trace_seconds"] = 0.3
    out = _run(spec, substitute=readings.control(spec, SEED, "cpu"),
               trace=True)
    assert "rrdb_body_ms" not in out["metrics"]
    rec = {"traced": {"engine_tiles": 8, "engine_calls": 1},
           "work": {"engine_tiles": 8}, "device_s":
           {"int8_conv3x3_wgmma": 0.1}, "config": spec.config,
           "counts": spec.counts, "peaks": cell.PEAKS}
    assert spec.metric_reader("rrdb_k2_roofline")(rec) is None


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs kernel K2 at its "
                    "own size")
    return "cuda"


@pytest.mark.cuda
def test_a_run_at_the_cells_size_is_correct_on_the_card(cuda):
    out = _run(cell.Spec(WORKLOAD), device=cuda, seconds=3.0)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [half_batch, altered_answer],
                         ids=["half_batch", "altered_answer"])
def test_a_broken_timed_path_is_not_correct_on_the_card(cuda, fault):
    out = _run(cell.Spec(WORKLOAD), substitute=fault, device=cuda,
               seconds=3.0)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_the_control_at_the_cells_size_is_not_correct_on_the_card(cuda):
    spec = cell.Spec(WORKLOAD)
    out = _run(spec, substitute=readings.control(spec, SEED, cuda),
               device=cuda, seconds=3.0)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_an_engine_call_launches_k2_345_times_on_the_card(cuda, recorder):
    """One 2048×1024 photo, one call of 8 tiles: 345 K2 launches, 8 tiles
    in `rrdb.tiles`, each of the three spans once."""
    from image_restoration_tpu_torch.ops.int8_conv import \
        int8_conv3x3_requant

    from benchmark.harness.weights import smooth_images

    spec = cell.Spec(WORKLOAD)
    _, engine = cell.build(spec, SEED, torch.device(cuda))
    img = smooth_images(1, 1024, 2048, SEED, "pool", cuda,
                        cell=16)[0].cpu().numpy()
    engine(img)
    recorder.reset()
    before = int8_conv3x3_requant.launches
    out = engine(img)
    assert out.shape == (4096, 8192, 3)
    assert int8_conv3x3_requant.launches - before == 345
    snap = recorder.snapshot()
    assert snap["counters"]["rrdb.tiles"] == 8
    names = [r[3] for r in snap["spans"]]
    for name in ("rrdb.head", "rrdb.body", "rrdb.tail"):
        assert names.count(name) == 1
