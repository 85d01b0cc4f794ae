"""cv2-compatible bilinear resize as two matrix products.

Port of `image_restoration_tpu/ops/resize.py:49-56,111-192`: any separable
resize is `out = R_h @ img @ R_w^T`, with the (out, in) weight matrices built
in numpy (cv2 half-pixel centres, border-replicate taps). Used for the
ConvUpLayer ×2 upsample and the Restorer input resize.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DeviceConstants


def cv2_resize_matrix(in_length: int, out_length: int,
                      interpolation: str = "bilinear") -> np.ndarray:
    """Dense (out, in) matrix matching cv2.resize along one axis: half-pixel
    centres `u = (i + 0.5) * in/out - 0.5`, border-replicate taps. Only the
    bilinear kernel is ported (the one the restore path uses)."""
    if interpolation not in ("bilinear", "linear"):
        raise ValueError(f"interpolation {interpolation!r} is not ported")
    u = (np.arange(out_length, dtype=np.float64) + 0.5) * \
        (in_length / out_length) - 0.5
    left = np.floor(u - 1.0) + 1
    indices = left[:, None] + np.arange(2)[None, :]
    weights = np.maximum(0.0, 1.0 - np.abs(u[:, None] - indices))
    wsum = weights.sum(axis=1, keepdims=True)
    weights = np.where(wsum > 0, weights / wsum, weights)
    idx = np.clip(indices.astype(np.int64), 0, in_length - 1)
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    for i in range(out_length):
        np.add.at(mat[i], idx[i], weights[i])
    return mat.astype(np.float32)


def _build_matrix(in_length: int, out_length: int, interpolation: str,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    mat = cv2_resize_matrix(in_length, out_length, interpolation)
    return torch.as_tensor(mat, device=device).to(dtype)


# the resize matrix on a device, built once per shape (few distinct shapes
# per network, so the cache stays small)
_matrix = DeviceConstants(_build_matrix, maxsize=64)


def resize(img: torch.Tensor, out_hw, interpolation: str = "bilinear") -> torch.Tensor:
    """cv2.resize-compatible resize of NHWC (or HWC) images."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    n, h, w, c = img.shape
    oh, ow = out_hw
    rh = _matrix(h, oh, interpolation, img.device, img.dtype)
    rw = _matrix(w, ow, interpolation, img.device, img.dtype)
    out = torch.matmul(rh, img.reshape(n, h, w * c)).reshape(n, oh, w, c)
    out = torch.matmul(rw, out)  # (ow, w) @ (n, oh, w, c) → (n, oh, ow, c)
    return out[0] if squeeze else out
