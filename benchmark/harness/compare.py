"""The numbers that decide `correct`: gaps between the program's uint8
answers and the reference's, in levels (LSB) of 8-bit colour."""

from __future__ import annotations

import numpy as np


def worst_block_mean(got: np.ndarray, want: np.ndarray, block: int) -> float:
    """The largest mean |got − want| over the block × block squares of
    every image ((H, W, C) or (N, H, W, C); edge blocks may be smaller).
    Answers of another shape read as infinitely far."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    d = d.reshape((-1,) + d.shape[-3:])
    worst = 0.0
    for img in d:
        for y in range(0, img.shape[0], block):
            for x in range(0, img.shape[1], block):
                worst = max(worst, float(img[y:y + block,
                                             x:x + block].mean()))
    return worst

