"""The element-wise steps of RRDBNet, rounded as the JAX package rounds them.

`archs/rrdbnet_arch.py` and the packed, widened and int8 forms in `ops/`
share them, so each form's bf16 arithmetic matches the JAX forward's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mul(x: torch.Tensor, s: float) -> torch.Tensor:
    """x · s with s first rounded to x's dtype, as JAX rounds a weakly typed
    Python scalar (for bf16, 0.2 becomes 0.2001953125)."""
    return x * torch.tensor(s, dtype=x.dtype)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) as the JAX package writes it: where(x ≥ 0, x, x·0.2)."""
    return torch.where(x >= 0, x, mul(x, 0.2))


def to_int8(t: torch.Tensor, r: torch.Tensor | None = None) -> torch.Tensor:
    """clip(round(t · r), ±127) as int8, t·r rounded to bf16 first; r None
    is the chain's factor 1."""
    t = t.to(torch.bfloat16)
    if r is not None:
        t = t * r
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, 2H, 2W, C), each pixel repeated 2×2."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)
