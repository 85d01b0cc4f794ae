"""The traced part of a `--trace 1` run: `torch.profiler` (CPU and CUDA)
over a steady stretch of the window, reduced to what the metric readers
take.

The stretch is the harness's own span `bench.window`, opened just after
the profiler starts and closed just before it stops. Device activity is
every CUDA event the profiler gives (kernels, copies, sets), clipped to
that span; the busy time is the length of their union. An idle gap is
named by what the host was doing at its middle: the harness span around
it and the innermost host event that covers it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self.prof = None
        self._span = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, fn) -> None:
        """Profile `fn()` once and drop it: the first profile of a process
        sets up the device tracing, which belongs to set-up."""
        with profile(activities=self.activities):
            fn()
            self._sync()

    def start(self) -> None:
        self._sync()
        self.prof = profile(activities=self.activities)
        self.prof.start()
        self._span = record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        self._sync()
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        return reduce_events(self.prof.events())


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """{window_s, busy_s, device_s: {name: s}, dtoh_s, htod_s, breakdown}
    from profiler events (times in microseconds)."""
    host, device = [], []
    window = None
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors each host span on the device's timeline
            # (a user annotation): that is no device activity
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                device.append((e.name, t0, t1))
        elif e.name == WINDOW:
            window = (t0, t1)
        else:
            host.append((e.name, t0, t1))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    ws, we = window
    per_name = defaultdict(float)
    clipped = []
    for name, t0, t1 in device:
        s, e = max(t0, ws), min(t1, we)
        if e > s:
            per_name[name] += (e - s) / 1e6
            clipped.append((s, e))
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, prev = [], ws
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if we > prev:
        gaps.append((prev, we))
    gaps.sort(key=lambda g: g[0] - g[1])
    bench = [h for h in host if h[0].startswith("bench.")]
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) / 2
        named.append([_host_at(mid, bench, host), (e - s) / 1e6])
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (we - ws) / 1e6, "busy_s": busy_s,
        "device_s": dict(per_name),
        "dtoh_s": sum(v for k, v in per_name.items() if "DtoH" in k),
        "htod_s": sum(v for k, v in per_name.items() if "HtoD" in k),
        "breakdown": {"device_ops": [[k[:200], v] for k, v in ops],
                      "idle_gaps": named},
    }


def _host_at(t: float, bench, host) -> str:
    """'<harness span> / <innermost host event>' covering time t."""
    def innermost(cands):
        cover = [h for h in cands if h[1] <= t <= h[2]]
        return max(cover, key=lambda h: h[1])[0] if cover else None

    outer = innermost(bench) or "no harness span"
    inner = innermost([h for h in host if not h[0].startswith("bench.")])
    return f"{outer} / {inner or 'no traced host event'}"[:200]
