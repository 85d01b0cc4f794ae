"""Optical-flow files.

Port of `image_restoration_tpu/utils/flow_util.py`: `.flo` read and write
(the "PIEH" header, width, height, then float32 (Δx, Δy) pairs), and the
quantized form, two uint8 maps of the flow divided by the image's size,
concatenated along `concat_axis` into one grayscale PNG.
"""

from __future__ import annotations

import os
from os import path as osp

import cv2
import numpy as np


def flowread(flow_path: str, quantize: bool = False, concat_axis: int = 0,
             *args, **kwargs) -> np.ndarray:
    """A `.flo` file, or a quantized flow image, as (H, W, 2) float32."""
    if quantize:
        cat_flow = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if cat_flow is None or cat_flow.ndim != 2:
            raise IOError(f"{flow_path} is not a valid quantized flow")
        if cat_flow.shape[concat_axis] % 2:
            raise IOError(f"{flow_path}: odd size along axis {concat_axis}")
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *args, **kwargs)
    with open(flow_path, "rb") as f:
        try:
            header = f.read(4).decode("utf-8")
        except UnicodeDecodeError:
            raise IOError(f"Invalid flow file: {flow_path}") from None
        if header != "PIEH":
            raise IOError(f"Invalid flow file header: {flow_path}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        flow = np.fromfile(f, np.float32, w * h * 2)
    return flow.reshape((h, w, 2))


def flowwrite(flow: np.ndarray, filename: str, quantize: bool = False,
              concat_axis: int = 0, *args, **kwargs) -> None:
    """Write (H, W, 2) flow as `.flo`, or quantized as one PNG."""
    if not quantize:
        with open(filename, "wb") as f:
            f.write(b"PIEH")
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
        return
    dx, dy = quantize_flow(flow, *args, **kwargs)
    os.makedirs(osp.dirname(osp.abspath(filename)), exist_ok=True)
    cv2.imwrite(filename, np.concatenate((dx, dy), axis=concat_axis))


def quantize_flow(flow: np.ndarray, max_val: float = 0.02,
                  norm: bool = True):
    """(dx, dy) uint8 maps of the flow (over W and H when `norm`), clipped
    to ±max_val."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx, dy = dx / w, dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8)
                 for d in (dx, dy))


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    """The inverse of `quantize_flow`: (H, W, 2) float64."""
    if dx.shape != dy.shape:
        raise ValueError(f"dx {dx.shape} and dy {dy.shape} differ")
    dx, dy = [dequantize(d, -max_val, max_val, 255) for d in (dx, dy)]
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """Uniform quantization of [min_val, max_val) into `levels` bins."""
    arr = np.clip(arr, min_val, max_val - 1e-9)
    return ((arr - min_val) / (max_val - min_val) * levels).astype(dtype)


def dequantize(arr, min_val, max_val, levels):
    """The centre of each bin."""
    return (arr.astype(np.float64) + 0.5) / levels * \
        (max_val - min_val) + min_val
