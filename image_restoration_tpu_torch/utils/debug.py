"""Opt-in numerical debugging.

Port of `image_restoration_tpu/utils/debug.py`: `debug_nans: true` in a
training YAML (or `nan_checks()` around a block) turns the checks on; off,
they cost nothing.

The checks are `torch.autograd.set_detect_anomaly`, which is not what
`jax_debug_nans` is: anomaly mode checks every backward function's output
for NaN and raises with the traceback of the forward op that made it, but
it does not check forward outputs. A NaN made in a forward pass shows up
at the first backward function it reaches (or not at all in a forward that
has no backward, such as a `no_grad` block), where JAX would stop at the
op itself. `checkify_step` has no counterpart: eager PyTorch raises its
index errors where they happen.
"""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Anomaly mode on (or off) for the whole process."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def nan_checks():
    """Anomaly mode inside the block; the previous mode after it."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
