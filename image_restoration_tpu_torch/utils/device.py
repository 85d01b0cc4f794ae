"""Resolution of the `device=` argument every entry point takes.

Unset means "cuda": the port never quietly runs on the CPU. Tests pass
`device="cpu"` explicitly.
"""

from __future__ import annotations

import collections
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """None → cuda (raises without a GPU); anything else → torch.device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return dev


class DeviceConstants:
    """Device tensors built once per key by `build(*key)` (the key names
    the device), at most `maxsize` of them, the least recently used dropped
    first: a fresh host→device copy per call would stall the host on every
    layer.

    They are built outside inference mode, so a torch.export trace can keep
    them as constants of the program. While torch.export traces, tensors
    are fake, and one built then would be rebuilt from host data on every
    call of the program; so a trace uses only tensors built before it, and
    a missing one raises (`serve.engine_restorer.export_graph` runs the
    graph once eagerly first)."""

    def __init__(self, build, maxsize: int = 64):
        self._build, self._maxsize = build, maxsize
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, *key) -> torch.Tensor:
        with self._lock:
            t = self._cache.get(key)
            if t is not None:
                self._cache.move_to_end(key)
                return t
        if torch.compiler.is_compiling():
            raise RuntimeError(f"device constant {key} was not built before "
                               "the trace: run the graph once eagerly first")
        with torch.inference_mode(False):
            t = self._build(*key)
        with self._lock:
            self._cache[key] = t
            while len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)
        return t


# torch.tensor(vals, dtype=dtype, device=device) for a small constant given
# as a (nested) tuple, built once per (vals, dtype, device)
const_tensor = DeviceConstants(
    lambda vals, dtype, device: torch.tensor(vals, dtype=dtype,
                                             device=device), maxsize=128)
