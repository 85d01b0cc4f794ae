"""Spans, counters and profiling hooks.

Port of `image_restoration_tpu/utils/profiler.py` on `torch.profiler`,
with the port's always-on recorder:

* `span(name)` times a block on `time.perf_counter_ns` into one bounded
  in-memory ring (the newest `RING_SIZE` records; the oldest are dropped).
  A span opened inside another on the same thread is its child; one with
  no parent on its thread is a root, and every span under it carries the
  root's id, so the spans of one call share one identifier. While a
  `torch.profiler` runs, a span is also a `record_function`, so it lands
  in the same trace as the kernels and copies it issues, on the device
  trace's clock; otherwise it costs about a microsecond and enters no
  `record_function`.
* `count(name, n)` adds to named integer counters.
* `snapshot()` returns both, and the hand-written kernels' launch counts;
  `calls(root)` breaks each recorded call of a root span down into the
  self time of the spans under it; `reset()` clears the ring and counters.

`trace(log_dir)` records CPU and CUDA activity and writes a Chrome trace
(`trace.json`, viewable in Perfetto or chrome://tracing) into `log_dir`;
`annotate(name)` is a span; `trace_training_window` profiles a few
optimizer steps after one warm-up step. PyTorch has no profiler server to
capture from on demand, so `start_server` raises.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Dict, List

import torch

RING_SIZE = 65536
# launch counters of the hand-written kernels: snapshot key → (module of
# the port, function that carries `.launches`)
_PKG = __name__.rsplit(".", 2)[0]
KERNEL_COUNTERS = {
    "k1.launches": (f"{_PKG}.ops.fused_act", "fused_leaky_relu"),
    "k2.launches": (f"{_PKG}.ops.int8_conv", "int8_conv3x3_requant"),
    "k3.launches": (f"{_PKG}.ops.im2col_conv", "conv3x3_im2col"),
}

# a deque's append, clear and copy are each atomic, so the ring needs no
# lock; the counters' read-modify-write does
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class span:
    """A timed block: `with span("restorer.h2d"): ...`.

    Records `(span id, parent id, root id, name, start_ns, end_ns)` when
    the block ends (the parent id of a root is None). Enters
    `torch.profiler.record_function(name)` only while a profiler runs."""

    __slots__ = ("name", "id", "parent", "root", "start", "_stack", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.start = _clock()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self._stack = stack
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._stack.pop()
        _ring.append((self.id, self.parent, self.root, self.name,
                      self.start, _clock()))


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """{"counters": {name: int}, "spans": [records, oldest first]}. The
    counters include the hand-written kernels' launch counts
    (`KERNEL_COUNTERS`) of the op modules already imported; none is
    imported here."""
    with _lock:
        counters = dict(_counters)
    spans = list(_ring)
    for key, (module, fn) in KERNEL_COUNTERS.items():
        mod = sys.modules.get(module)
        if mod is not None:
            counters[key] = getattr(mod, fn).launches
    return {"counters": counters, "spans": spans}


def reset() -> None:
    """Clear the ring and the counters (the kernels' launch counts stay)."""
    _ring.clear()
    with _lock:
        _counters.clear()


def calls(root: str) -> List[Dict[str, float]]:
    """One dict per recorded root span named `root`, oldest first: the
    summed self seconds (duration minus that of its direct children) of
    each span name under it, and under `root` itself the root's whole
    duration."""
    spans = list(_ring)
    covered = collections.Counter()
    for _, parent, _, _, t0, t1 in spans:
        if parent is not None:
            covered[parent] += t1 - t0
    out = {sid: {name: (t1 - t0) / 1e9}
           for sid, parent, _, name, t0, t1 in spans
           if parent is None and name == root}
    for sid, parent, rid, name, t0, t1 in spans:
        if parent is not None and rid in out:
            per = out[rid]
            per[name] = per.get(name, 0.0) + (t1 - t0 - covered[sid]) / 1e9
    return [out[rid] for rid in sorted(out)]


def start_server(port: int = 9999):
    """JAX's on-demand profiler server has no PyTorch counterpart."""
    raise NotImplementedError(
        "PyTorch has no profiler server to capture from on demand; wrap the "
        "work in utils.profiler.trace(log_dir) instead")


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the work inside the block (CPU, and CUDA when there is a card)
    into `log_dir`/trace.json; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> span:
    """A named span, visible in captured traces."""
    return span(name)


def trace_training_window(model, batches, generator, log_dir: str,
                          num_steps: int = 3, start_iter: int = 1) -> str:
    """Profile `num_steps` optimizer steps of `model`, each in a
    `train_step_{i}` span, after one warm-up step outside the trace;
    `generator` feeds every step's random draws. Returns `log_dir`."""
    model.optimize_parameters(start_iter, batches[0], generator)
    with trace(log_dir):
        for i in range(1, num_steps + 1):
            with annotate(f"train_step_{i}"):
                model.optimize_parameters(start_iter + i,
                                          batches[i % len(batches)],
                                          generator)
    return log_dir
