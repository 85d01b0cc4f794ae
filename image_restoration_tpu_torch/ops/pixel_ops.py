"""Pixel shuffle / unshuffle for NHWC tensors.

Port of `image_restoration_tpu/ops/pixel_ops.py:18-35`. The channel order is
torch's: an NCHW channel axis read as (C, r, r) blocks, here the last axis, so
imported weights behave as in the reference checkpoint.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H, W, C·r²) → (N, H·r, W·r, C)."""
    n, h, w, c = x.shape
    r = scale
    x = x.reshape(n, h, w, c // (r * r), r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # n, h, r, w, r, c
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H·r, W·r, C) → (N, H, W, C·r²); the inverse of pixel_shuffle."""
    n, hh, ww, c = x.shape
    r = scale
    x = x.reshape(n, hh // r, r, ww // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # n, h, w, c, r, r
    return x.reshape(n, hh // r, ww // r, c * r * r)
