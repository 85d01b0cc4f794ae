"""`sr_pinned_share`, read from the `EngineRestorer` output path's counters
(`engine_restorer.pinned_out`, `engine_restorer.pageable_out`): on the CPU
every output is already in host memory and the share reads 0; with the
control in the program's place there are no counters and the metric is
left out; on the card every output lands in page-locked memory and the
share reads 100.

    python -m pytest -m cuda benchmark/tests/test_portbench_pinned.py
"""

import time

import pytest
import torch

from benchmark.harness import cell, readings

from .tiny import tiny_spec

SEED = 2 ** 34 + 91
CELLS = ["srx4.small", "srx4.wide"]


@pytest.fixture
def recorder():
    from image_restoration_tpu_torch.utils import profiler

    profiler.reset()
    return profiler


def _traced(spec, device="cpu", seconds=0.6, substitute=None):
    spec.traffic["trace_seconds"] = 0.3
    return cell.run(spec, SEED, seconds, True, device, time.monotonic(),
                    substitute=substitute)


@pytest.mark.parametrize("workload", CELLS)
def test_on_the_cpu_no_output_is_pinned(recorder, workload):
    out = _traced(tiny_spec(workload))
    assert out["correct"], out["checks"]
    assert out["metrics"]["sr_pinned_share"]["value"] == 0.0
    counters = recorder.snapshot()["counters"]
    assert counters["engine_restorer.pageable_out"] > 0
    assert "engine_restorer.pinned_out" not in counters


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_leaves_the_share_out(recorder, workload):
    spec = tiny_spec(workload)
    out = _traced(spec, substitute=readings.control(spec, SEED, "cpu"))
    assert "sr_pinned_share" not in out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card_every_output_is_pinned(recorder, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned path runs only there")
    out = _traced(cell.Spec(workload), device="cuda", seconds=3.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["sr_pinned_share"]["value"] == 100.0
    assert "engine_restorer.pageable_out" not in \
        recorder.snapshot()["counters"]
