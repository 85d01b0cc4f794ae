"""What the traffic drivers share: a seeded sample of a run's answers, and
a closed loop with one caller that times the window on the host clock and
traces a stretch of it.

A driver is a file `benchmark/drivers/<driver>.py`, named by a traffic
file's `"driver"`, that exports `Driver`: a class built as
`Driver(program, traffic, seed, device, seconds)` with `setup(tracer)`,
`window(seconds, tracer, started)` → the run's records, `close()` and
`check(reference)` → {number compared: value}. Most subclass `ClosedLoop`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .weights import sub_seed


class Reservoir:
    """A uniform seeded sample of `k` items from a stream of unknown
    length (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class ClosedLoop:
    """A closed loop with one caller. Subclasses give `_call(i)` → (kept
    item, answers), `check(reference)` and the traffic's inputs, and may
    count work in `_counters()`.

    The records: `setup_s`; over the whole window `elapsed_s`, `calls`,
    `answers`, `attempted`, `failed`, `work` (the counters); and, in a
    traced run, `traced`: the calls, answers and counters of the traced
    stretch, whose device work lies inside the traced span."""

    def __init__(self, program, traffic, seed, device, seconds):
        self.program, self.t, self.seed = program, traffic, seed
        self.device = torch.device(device)
        self.keep = Reservoir(traffic["keep"], sub_seed(seed, "keep"))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, tracer):
        for i in range(self.t["warmup_calls"]):
            self._call(i)
        self._sync()
        if tracer is not None:
            tracer.warm(lambda: self._call(0))
        self._reset_counters()

    def _reset_counters(self):
        pass

    def _counters(self) -> dict:
        return {}

    def window(self, seconds, tracer, started):
        t0 = time.monotonic()
        rec = {"setup_s": t0 - started}
        done = failed = calls = 0
        trace_from = t0 + self.t["trace_after"] * seconds
        traced = None

        def more():  # the window, then the rest of the traced stretch
            if time.monotonic() - t0 < seconds:
                return True
            if tracer is None:
                return False
            return traced is None or "stopped" not in traced

        while more():
            if tracer is not None and traced is None and \
                    time.monotonic() >= trace_from:
                # trace whole calls for about trace_seconds
                per_call = (time.monotonic() - t0) / max(calls, 1)
                want = max(3, math.ceil(self.t["trace_seconds"] / per_call))
                traced = {"calls": 0, "want": want, "answers": 0,
                          **self._counters()}
                tracer.start()
            try:
                with record_function("bench.call"):
                    item, n = self._call(calls)
                self.keep.offer(item)
                done += n
            except Exception as exc:  # a failed call is counted, not fatal
                n = 0
                failed += self.t["answers_per_call"]
                rec.setdefault("errors", []).append(repr(exc)[:300])
            calls += 1
            if traced is not None and "stopped" not in traced:
                traced["calls"] += 1
                traced["answers"] += n
                if traced["calls"] >= traced["want"]:
                    tracer.stop()
                    traced["stopped"] = True
                    for k, v in self._counters().items():
                        traced[k] = v - traced[k]
        elapsed = time.monotonic() - t0
        rec.update(elapsed_s=elapsed, calls=calls, answers=done,
                   attempted=done + failed, failed=failed,
                   work=self._counters(), traced=traced)
        return rec

    def close(self):
        self.program = None
