"""The per-layer metrics read from the program's own spans and counters
(`harness/spans.py`, `utils/profiler.py` of the port): a traced run of
each cell reports them; a run with the control in the program's place
does not, since the recorder is per process and the control records
nothing; and on the card the profiler's mirror of a program span on the
device's timeline is not counted as device work.

    python -m pytest -m cuda benchmark/tests/test_portbench_spans.py
"""

import math
import time

import pytest
import torch

from benchmark.harness import cell, readings, trace

from .tiny import tiny_spec

SEED = 2 ** 34 + 77
NEW = {
    "ocr256.batch32": ["restore_h2d_ms", "restore_issue_ms",
                       "restore_d2h_ms"],
    "srx4.wide": ["sr_issue_ms", "sr_tiler_ms", "sr_d2h_ms", "tiler_fill"],
    "srx4.small": ["sr_issue_ms", "sr_tiler_ms", "sr_d2h_ms", "tiler_fill"],
}
PROGRAM_SPANS = ("restorer.", "engine_restorer.", "tiler.")


@pytest.fixture
def recorder():
    from image_restoration_tpu_torch.utils import profiler

    profiler.reset()
    return profiler


def _traced(spec, device="cpu", seconds=0.6, substitute=None):
    return cell.run(spec, SEED, seconds, True, device, time.monotonic(),
                    substitute=substitute)


def _short(spec):
    spec.traffic["trace_seconds"] = 0.3
    return spec


@pytest.mark.parametrize("workload", sorted(NEW))
def test_a_traced_run_reports_the_program_spans(recorder, workload):
    out = _traced(_short(tiny_spec(workload)))
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW[workload]:
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0
    if "tiler_fill" in got:
        assert got["tiler_fill"]["value"] == got["sr_tile_fill"]["value"]


@pytest.mark.parametrize("workload", sorted(NEW))
def test_the_control_leaves_the_program_spans_out(recorder, workload):
    spec = _short(tiny_spec(workload))
    out = _traced(spec, substitute=readings.control(spec, SEED, "cpu"))
    assert not set(NEW[workload]) & set(out["metrics"])
    assert recorder.calls("restorer.restore_batch_u8") == []
    assert recorder.calls("engine_restorer.call") == []


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace's mirror of a "
                    "span exists only on the card")
    return "cuda"


def _is_program_span(name: str) -> bool:
    return name.startswith(PROGRAM_SPANS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(NEW))
def test_program_spans_are_no_device_work_on_the_card(
        cuda, recorder, workload, monkeypatch):
    """The traced stretch reduced twice: as the harness does, and with
    every program span's event (host and device side) taken out first.
    The device time by name and the busy time come out the same, so the
    spans move no `idle.*`, and no span name is device work."""
    reduced = {}
    inner = trace.reduce_events

    def both(events):
        events = list(events)
        reduced["with"] = inner(events)
        reduced["without"] = inner([e for e in events
                                    if not _is_program_span(e.name)])
        reduced["spans"] = sum(_is_program_span(e.name) for e in events)
        return reduced["with"]

    monkeypatch.setattr(trace, "reduce_events", both)
    out = _traced(cell.Spec(workload), device=cuda, seconds=3.0)
    assert out["correct"], out["checks"]
    assert reduced["spans"] > 0
    got, base = reduced["with"], reduced["without"]
    assert not [k for k in got["device_s"] if _is_program_span(k)]
    assert not [k for k, _ in out["breakdown"]["device_ops"]
                if _is_program_span(k)]
    assert got["device_s"] == base["device_s"]
    assert got["busy_s"] == base["busy_s"]
    assert got["window_s"] == base["window_s"]
    for name in NEW[workload]:
        assert name in out["metrics"], name
