"""Metric helpers (numpy).

A copy of `image_restoration_tpu/metrics/metric_util.py`: MATLAB-convention
YCbCr (Y in [16, 235] for uint8-range inputs) and the HWC reorder.
"""

from __future__ import annotations

import numpy as np


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR [0,1] float → YCbCr (MATLAB convention)."""
    img = img.astype(np.float64)
    if y_only:
        out = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(img, [[24.966, 112.0, -18.214],
                              [128.553, -74.203, -93.786],
                              [65.481, -37.797, 112.0]]) + \
            [16, 128, 128]
    return out / 255.0


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0,255] BGR HWC → Y channel [0,255] float64."""
    img = img.astype(np.float64) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


def reorder_image(img: np.ndarray, input_order: str = "HWC") -> np.ndarray:
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[..., None]
    return img
