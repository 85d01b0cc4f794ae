"""Resolution of the `device=` argument every entry point takes.

Unset means "cuda": the port never quietly runs on the CPU. Tests pass
`device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None → cuda (raises without a GPU); anything else → torch.device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return dev
