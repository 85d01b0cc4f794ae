"""The port's span recorder (`utils/profiler.py`) and the spans and counters
of the restore and ×4 SR paths, on the CPU with one torch thread:

  * a span's parent, root and id; `calls`' self time (duration minus the
    direct children); one stack per thread; the ring keeps the newest
    `RING_SIZE` records; counters under many threads;
  * with no profiler running, no span enters `record_function`; under
    `trace` the spans are in `trace.json`, nested as recorded;
  * `Restorer.restore_batch_u8` records one root a call over exactly
    `restorer.h2d`, `restorer.forward` and `restorer.d2h`, in that order;
  * `EngineRestorer` on a photo of 2 tiles at engine batch 8 records the
    root over h2d, the tiler's split, run and stitch, and d2h, and the
    tiler counts 8 tiles handed and 6 of padding.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.serve.engine_restorer import EngineRestorer
from image_restoration_tpu_torch.utils import profiler


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset()
    yield
    torch.set_num_threads(n)


def _records():
    return profiler.snapshot()["spans"]


def _children(root_name):
    """{root id: [child names in start order]} of the recorded roots."""
    spans = _records()
    roots = {s[0] for s in spans if s[1] is None and s[3] == root_name}
    out = {r: [] for r in roots}
    for sid, parent, rid, name, t0, _ in sorted(spans, key=lambda s: s[4]):
        if parent is not None and rid in out:
            out[rid].append(name)
    return out


# ------------------------------------------------------------- recorder

def test_span_parent_root_and_id():
    with profiler.span("a") as a:
        with profiler.span("b") as b:
            with profiler.span("c") as c:
                pass
    with profiler.span("d") as d:
        pass
    rec = {s[3]: s for s in _records()}
    assert rec["a"][:3] == (a.id, None, a.id)
    assert rec["b"][:3] == (b.id, a.id, a.id)
    assert rec["c"][:3] == (c.id, b.id, a.id)
    assert rec["d"][:3] == (d.id, None, d.id)
    assert len({a.id, b.id, c.id, d.id}) == 4
    for s in rec.values():
        assert s[4] <= s[5]
    # children end first, and the ring keeps the order records end in
    assert [s[3] for s in _records()] == ["c", "b", "a", "d"]


def test_self_time_is_duration_minus_children():
    for _ in range(2):
        with profiler.span("root"):
            time.sleep(0.01)
            with profiler.span("x"):
                time.sleep(0.02)
                with profiler.span("y"):
                    time.sleep(0.03)
            with profiler.span("x"):
                time.sleep(0.01)
    spans = _records()
    calls = profiler.calls("root")
    assert len(calls) == 2
    dur = {s[0]: (s[5] - s[4]) / 1e9 for s in spans}
    for call, root in zip(calls, [s for s in spans if s[3] == "root"]):
        assert set(call) == {"root", "x", "y"}
        assert call["root"] == dur[root[0]]
        xs = [s for s in spans if s[3] == "x" and s[2] == root[0]]
        y = next(s for s in spans if s[3] == "y" and s[2] == root[0])
        assert call["y"] == pytest.approx(dur[y[0]], abs=1e-9)
        assert call["x"] == pytest.approx(
            sum(dur[s[0]] for s in xs) - dur[y[0]], abs=1e-9)
        assert 0.025 < call["x"] < call["root"] - call["y"]
        # the root's self time is what its children leave uncovered
        assert call["root"] - call["x"] - call["y"] >= 0.009
    assert profiler.calls("x") == [] and profiler.calls("absent") == []


def test_each_thread_has_its_own_stack():
    inside, release = threading.Event(), threading.Event()
    ids = {}

    def worker():
        with profiler.span("worker") as w:
            ids["worker"] = w.id
            inside.set()
            release.wait(10)
            with profiler.span("worker.child") as c:
                ids["worker.child"] = c.id

    with profiler.span("main") as m:
        t = threading.Thread(target=worker)
        t.start()
        assert inside.wait(10)
        with profiler.span("main.child") as mc:
            ids["main.child"] = mc.id
        release.set()
        t.join(10)
    assert not t.is_alive()
    rec = {s[3]: s for s in _records()}
    assert rec["worker"][1:3] == (None, ids["worker"])
    assert rec["worker.child"][1:3] == (ids["worker"], ids["worker"])
    assert rec["main.child"][1:3] == (m.id, m.id)


def test_the_ring_drops_the_oldest():
    n = profiler.RING_SIZE + 10
    for i in range(n):
        with profiler.span(f"s{i}"):
            pass
    spans = _records()
    assert len(spans) == profiler.RING_SIZE
    assert spans[0][3] == "s10" and spans[-1][3] == f"s{n - 1}"
    profiler.reset()
    assert _records() == [] and profiler.snapshot()["counters"].get(
        "tiler.tiles") is None


def test_counters_under_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            profiler.count("hits") or profiler.count("pairs", 2)
            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    counters = profiler.snapshot()["counters"]
    assert counters["hits"] == 16 * 2000 and counters["pairs"] == 4 * 16000


def test_snapshot_reports_the_kernels_launch_counters():
    from image_restoration_tpu_torch.ops import fused_act
    counters = profiler.snapshot()["counters"]
    assert counters["k1.launches"] == fused_act.fused_leaky_relu.launches
    for key, (module, _) in profiler.KERNEL_COUNTERS.items():
        assert (key in counters) == (module in sys.modules)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiler.span("a"):
        with profiler.annotate("b"):
            pass
    restorer = _narrow_restorer()
    restorer.restore_batch_u8(np.zeros((2, 32, 32, 3), np.uint8))
    _engine()(np.zeros((70, 100, 3), np.uint8))
    assert len(profiler.calls("restorer.restore_batch_u8")) == 1
    assert len(profiler.calls("engine_restorer.call")) == 1


def test_spans_land_in_the_trace_nested_as_recorded(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.span("outer"):
            torch.ones(32, 32) @ torch.ones(32, 32)
            with profiler.span("inner"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = {e["name"]: e for e in json.load(
        open(tmp_path / "trace.json"))["traceEvents"]
        if e.get("name") in ("outer", "inner") and e.get("ph") == "X"
        and e.get("cat") == "user_annotation"}
    assert set(events) == {"outer", "inner"}
    o, i = events["outer"], events["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    rec = {s[3]: s for s in _records()}
    assert rec["inner"][1] == rec["outer"][0]


# ------------------------------------------------- restore and ×4 SR paths

def _narrow_restorer():
    return Restorer(dict(type="GFPGANv1OCR", input_width=32, input_height=32,
                         num_style_feat=32, channel_multiplier=0.5,
                         num_mlp=2, input_is_latent=True, different_w=True,
                         narrow=0.0625, sft_half=True), device="cpu")


def _engine():
    return EngineRestorer.build(num_feat=8, num_conv=2, upscale=4, tile=64,
                                halo=4, batch=8, seed=3, device="cpu")


def test_restore_batch_u8_records_h2d_forward_d2h():
    restorer = _narrow_restorer()
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                              dtype=np.uint8)
    for _ in range(2):
        restorer.restore_batch_u8(imgs)
    per_root = _children("restorer.restore_batch_u8")
    assert len(per_root) == 2
    for names in per_root.values():
        assert names == ["restorer.h2d", "restorer.forward", "restorer.d2h"]
    for call in profiler.calls("restorer.restore_batch_u8"):
        assert all(v > 0 for v in call.values())


def test_engine_restorer_records_the_tiler_and_counts_its_fill():
    engine = _engine()
    photo = np.random.default_rng(1).integers(0, 256, (40, 100, 3),
                                               dtype=np.uint8)
    before = profiler.snapshot()["counters"]
    assert "tiler.tiles" not in before
    for k in (1, 2):
        out = engine(photo)
        assert out.shape == (160, 400, 3) and out.dtype == np.uint8
        counters = profiler.snapshot()["counters"]
        assert counters["tiler.tiles"] == 8 * k
        assert counters["tiler.pad_tiles"] == 6 * k
    per_root = _children("engine_restorer.call")
    assert len(per_root) == 2
    for names in per_root.values():
        assert names == ["engine_restorer.h2d", "tiler.split", "tiler.split",
                         "tiler.run", "tiler.stitch", "engine_restorer.d2h"]
    for call in profiler.calls("engine_restorer.call"):
        assert set(call) == {"engine_restorer.call", "engine_restorer.h2d",
                             "tiler.split", "tiler.run", "tiler.stitch",
                             "engine_restorer.d2h"}
