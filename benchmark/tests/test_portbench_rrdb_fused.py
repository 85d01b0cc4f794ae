"""`rrdb_fused_share`, read from the RRDB forward's counters
(`rrdb.stages`, `rrdb.fused_stages`): a traced `rrdb_x4.wide` run at the
CPU cut of `test_portbench_rrdb.py` reads 100 (the forward runs every stage
conv on K2's RRDB stage op, whose plain version runs here); with the control
in the program's place there are no counters and the metric is left out;
a program that counts stage convs but fuses none reads 0.

    python -m pytest -m cuda benchmark/tests/test_portbench_rrdb_fused.py
"""

import time

import pytest
import torch

from benchmark.harness import cell, readings

from .test_portbench_rrdb import SEED, WORKLOAD, cut_spec


@pytest.fixture
def recorder():
    from image_restoration_tpu_torch.utils import profiler

    profiler.reset()
    return profiler


def _traced(spec, device="cpu", seconds=0.6, substitute=None):
    spec.traffic["trace_seconds"] = 0.3
    return cell.run(spec, SEED, seconds, True, device, time.monotonic(),
                    substitute=substitute)


def test_every_stage_conv_is_fused(recorder):
    out = _traced(cut_spec())
    assert out["correct"], out["checks"]
    assert out["metrics"]["rrdb_fused_share"] == {"value": 100.0,
                                                  "unit": "%"}
    counters = recorder.snapshot()["counters"]
    assert counters["rrdb.stages"] == counters["rrdb.fused_stages"] > 0
    assert counters["rrdb.stages"] % (15 * 4) == 0  # 15 a block, 4 blocks


def test_the_control_leaves_the_share_out(recorder):
    spec = cut_spec()
    out = _traced(spec, substitute=readings.control(spec, SEED, "cpu"))
    assert "rrdb_fused_share" not in out["metrics"]


def test_stage_convs_without_the_fused_epilogue_read_zero(recorder):
    read = cell.Spec(WORKLOAD).metric_reader("rrdb_fused_share")
    assert read({}) is None
    recorder.count("rrdb.stages", 45)
    assert read({}) == 0.0
    recorder.count("rrdb.fused_stages", 15)
    assert read({}) == pytest.approx(100.0 / 3)


@pytest.mark.cuda
def test_on_the_card_every_stage_conv_is_fused(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs kernel K2 at its "
                    "own size")
    out = _traced(cell.Spec(WORKLOAD), device="cuda", seconds=3.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["rrdb_fused_share"]["value"] == 100.0
