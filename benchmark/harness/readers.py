"""Arithmetic the metric readers share, over a run's records `rec`.

A reader returns None where its run has nothing to read (no traced
window, no device time of its kernel); the harness then leaves the metric
out of the result line.
"""

from __future__ import annotations


def idle_percent(rec: dict):
    """Share of the traced window in which no kernel, copy or set ran."""
    if not rec.get("window_s") or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def kernel_seconds(rec: dict, key: str) -> float:
    """Device seconds of the traced kernels whose name holds `key`."""
    return sum(v for k, v in rec.get("device_s", {}).items() if key in k)


def per_busy_second(rec: dict, key: str):
    """`rec["traced"][key]` (work of the traced stretch's whole calls) per
    second in which the device was busy in it: device time from the trace,
    which the profiler's slowing of the host's launches does not touch."""
    traced = rec.get("traced")
    if not traced or not rec.get("busy_s"):
        return None
    return traced[key] / rec["busy_s"]
