"""Readers of the program's own spans and counters: the recorder of
`image_restoration_tpu_torch/utils/profiler.py`, in this process.

The recorder's ring holds every call of the run, the warm-up and the
traced stretch included, so a reader takes the median over the calls.
A reader returns None where the process holds no recorder (a program
without one was run, or none) or the recorder holds no call of its root
span (the control, a substitute); it never imports the port itself.
"""

from __future__ import annotations

import statistics
import sys

PROFILER = "image_restoration_tpu_torch.utils.profiler"


def _recorder():
    mod = sys.modules.get(PROFILER)
    return mod if mod is not None and hasattr(mod, "calls") else None


def median_ms(root: str, names) -> float | None:
    """Median over the recorded calls of the root span `root` of the
    summed self time of the spans `names` under it, in milliseconds."""
    rec = _recorder()
    calls = rec.calls(root) if rec is not None else []
    if not calls:
        return None
    return 1e3 * statistics.median(sum(c.get(n, 0.0) for n in names)
                                   for c in calls)


def counters() -> dict:
    """The recorder's counters ({} without a recorder)."""
    rec = _recorder()
    return rec.snapshot()["counters"] if rec is not None else {}
