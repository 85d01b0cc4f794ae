"""Profiling hooks around training windows.

Port of `image_restoration_tpu/utils/profiler.py` on `torch.profiler`:
`trace(log_dir)` records CPU and CUDA activity and writes a Chrome trace
(`trace.json`, viewable in Perfetto or chrome://tracing) into `log_dir`;
`annotate(name)` is a named span in it; `trace_training_window` profiles a
few optimizer steps after one warm-up step. PyTorch has no profiler
server to capture from on demand, so `start_server` raises.
"""

from __future__ import annotations

import contextlib
import os

import torch


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


def annotate(name: str):
    """A named span visible in captured traces."""
    return torch.profiler.record_function(name)


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
