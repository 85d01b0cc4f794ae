"""cv2-compatible resize (bilinear, bicubic and area as two matrix
products, nearest as two gathers) and MATLAB's bicubic `imresize`.

Port of `image_restoration_tpu/ops/resize.py:29-192`: any separable
resize is `out = R_h @ img @ R_w^T`, with the (out, in) weight matrices built
in numpy (cv2 half-pixel centres, border-replicate taps). Used for the
ConvUpLayer ×2 upsample, the Restorer input resize and the GFPGAN trainer's
GT pyramid. `imresize` is MATLAB's bicubic (a = −0.5, the kernel widened
by 1/scale when antialiased downscaling, symmetric edges), the resize of
`scripts/matlab_scripts.py`'s test and training sets.

`dynamic_resize_matrix` (JAX `ops/resize.py:198`) builds the matrices for
a per-sample scale held in a tensor, on its device, for a whole batch at
once: the degradation chain's random down/up round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DeviceConstants


def _cubic_matlab(x):
    """MATLAB's bicubic kernel (a = −0.5)."""
    absx = np.abs(x)
    absx2, absx3 = absx ** 2, absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) +
            (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2) *
            ((absx > 1) & (absx <= 2)))


def matlab_resize_matrix(in_length: int, out_length: int,
                         antialiasing: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) MATLAB-bicubic weight matrix (JAX
    `ops/resize.py:57-92`): 1-indexed centres, the kernel widened by
    1/scale when antialiased downscaling, weights renormalized per row,
    out-of-range taps mirrored."""
    scale = out_length / in_length
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]  # (out, p), 1-indexed
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic_matlab(dist * scale)
    else:
        weights = _cubic_matlab(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)
    idx = (indices - 1).astype(np.int64)  # 0-indexed, then mirrored
    aux = np.concatenate([np.arange(in_length),
                          np.arange(in_length - 1, -1, -1)])
    idx = aux[np.mod(idx, 2 * in_length)]
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    for i in range(out_length):
        np.add.at(mat[i], idx[i], weights[i])
    return mat.astype(np.float32)


def _cubic_cv2(x):
    """cv2's INTER_CUBIC kernel (a = −0.75)."""
    a = -0.75
    absx = np.abs(x)
    absx2, absx3 = absx ** 2, absx ** 3
    return (((a + 2) * absx3 - (a + 3) * absx2 + 1) * (absx <= 1) +
            (a * absx3 - 5 * a * absx2 + 8 * a * absx - 4 * a) *
            ((absx > 1) & (absx < 2)))


def _area_down_matrix(in_length: int, out_length: int) -> np.ndarray:
    """cv2's INTER_AREA when downscaling: each output pixel is the mean of
    the source pixels it covers, a partly covered one weighted by its
    share."""
    s = in_length / out_length
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    for i in range(out_length):
        lo, hi = i * s, (i + 1) * s
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), in_length)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                mat[i, j] = cover / s
    return mat.astype(np.float32)


def cv2_resize_matrix(in_length: int, out_length: int,
                      interpolation: str = "bilinear") -> np.ndarray:
    """Dense (out, in) matrix matching cv2.resize along one axis (JAX
    `ops/resize.py:111-175`).

    bilinear and bicubic: half-pixel centres `u = (i + 0.5) * in/out - 0.5`,
    border-replicate taps, the weights renormalized per row (bicubic is
    cv2's a = −0.75 kernel over 4 taps); bilinear_ac: torch's
    `align_corners=True`, `u = i * (in - 1)/(out - 1)`. area: exact
    coverage when downscaling; when upscaling cv2's INTER_AREA samples as
    bilinear does, and so does this. nearest: cv2's INTER_NEAREST,
    `src = min(floor(i * in/out), in - 1)`, one-hot rows (`resize` gathers
    those rows instead of multiplying, so the result is exact)."""
    if interpolation == "area" and in_length > out_length:
        return _area_down_matrix(in_length, out_length)
    if interpolation == "nearest":
        mat = np.zeros((out_length, in_length), dtype=np.float32)
        mat[np.arange(out_length), nearest_index(in_length, out_length)] = 1
        return mat
    kernel, support = lambda d: np.maximum(0.0, 1.0 - np.abs(d)), 1.0
    if interpolation == "bilinear_ac":   # torch's align_corners=True
        u = (np.zeros(1) if out_length == 1 else
             np.arange(out_length, dtype=np.float64) *
             (in_length - 1) / (out_length - 1))
    elif interpolation in ("bilinear", "linear", "area", "bicubic", "cubic"):
        if interpolation in ("bicubic", "cubic"):
            kernel, support = _cubic_cv2, 2.0
        u = (np.arange(out_length, dtype=np.float64) + 0.5) * \
            (in_length / out_length) - 0.5
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    left = np.floor(u - support) + 1
    indices = left[:, None] + np.arange(int(2 * support))[None, :]
    weights = kernel(u[:, None] - indices)
    wsum = weights.sum(axis=1, keepdims=True)
    weights = np.where(wsum > 0, weights / wsum, weights)
    idx = np.clip(indices.astype(np.int64), 0, in_length - 1)
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    for i in range(out_length):
        np.add.at(mat[i], idx[i], weights[i])
    return mat.astype(np.float32)


def nearest_index(in_length: int, out_length: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index per output index (JAX
    `ops/resize.py:132-137`)."""
    s = in_length / out_length
    return np.minimum((np.arange(out_length) * s).astype(np.int64),
                      in_length - 1)


def _build_index(in_length: int, out_length: int,
                 device: torch.device) -> torch.Tensor:
    return torch.as_tensor(nearest_index(in_length, out_length),
                           device=device)


def _build_matrix(in_length: int, out_length: int, interpolation: str,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    mat = cv2_resize_matrix(in_length, out_length, interpolation)
    return torch.as_tensor(mat, device=device).to(dtype)


# the resize matrix on a device, built once per shape (few distinct shapes
# per network, so the cache stays small)
_matrix = DeviceConstants(_build_matrix, maxsize=64)
_index = DeviceConstants(_build_index, maxsize=64)
_matlab = DeviceConstants(
    lambda i, o, aa, device, dtype: torch.as_tensor(
        matlab_resize_matrix(i, o, aa), device=device).to(dtype), maxsize=64)


def imresize(img: torch.Tensor, scale: float,
             antialiasing: bool = True) -> torch.Tensor:
    """MATLAB's bicubic resize of NHWC (or HWC) float images by `scale`, to
    ceil(h·scale) × ceil(w·scale): two contractions on the images' device
    (JAX `ops/resize.py:94-108`)."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    h, w = img.shape[1], img.shape[2]
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    rh = _matlab(h, oh, antialiasing, img.device, img.dtype)
    rw = _matlab(w, ow, antialiasing, img.device, img.dtype)
    out = torch.einsum("oh,nhwc->nowc", rh, img)
    out = torch.einsum("pw,nowc->nopc", rw, out)
    return out[0] if squeeze else out


def resize(img: torch.Tensor, out_hw, interpolation: str = "bilinear") -> torch.Tensor:
    """cv2.resize-compatible resize of NHWC (or HWC) images."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    n, h, w, c = img.shape
    oh, ow = out_hw
    if interpolation == "nearest":   # a gather: exact, whatever the matmul
        out = img.index_select(1, _index(h, oh, img.device))
        out = out.index_select(2, _index(w, ow, img.device))
        return out[0] if squeeze else out
    rh = _matrix(h, oh, interpolation, img.device, img.dtype)
    rw = _matrix(w, ow, interpolation, img.device, img.dtype)
    out = torch.matmul(rh, img.reshape(n, h, w * c)).reshape(n, oh, w, c)
    out = torch.matmul(rw, out)  # (ow, w) @ (n, oh, w, c) → (n, oh, ow, c)
    return out[0] if squeeze else out


def dynamic_resize_matrix(out_length: int, in_length: int,
                          scale: torch.Tensor, valid_out: torch.Tensor,
                          interpolation: str = "bilinear") -> torch.Tensor:
    """(..., out_length, in_length) weight matrices for per-sample scales.

    `scale` (the src/dst step) and `valid_out` (the count of meaningful
    output rows) are tensors of one shape (...), e.g. (N,); rows at or past
    `valid_out` are zero. Modes: bilinear/linear, bicubic/cubic (cv2's
    a = -0.75) and area (a triangle of width max(scale, 1), the smooth
    surrogate of box coverage), as the JAX function has them.
    """
    scale = torch.as_tensor(scale, dtype=torch.float32)
    dev = scale.device
    valid_out = torch.as_tensor(valid_out, device=dev)
    s = scale[..., None, None]
    i = torch.arange(out_length, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(in_length, dtype=torch.float32, device=dev)[None, :]
    d = ((i + 0.5) * s - 0.5) - j
    if interpolation in ("bilinear", "linear"):
        w = torch.clamp(1.0 - torch.abs(d), min=0.0)
    elif interpolation in ("bicubic", "cubic"):
        a = -0.75
        ad = torch.abs(d)
        w = torch.where(ad <= 1, (a + 2) * ad ** 3 - (a + 3) * ad ** 2 + 1,
                        torch.where(ad < 2, a * ad ** 3 - 5 * a * ad ** 2
                                    + 8 * a * ad - 4 * a,
                                    torch.zeros_like(ad)))
    elif interpolation == "area":
        width = torch.clamp(s, min=1.0)
        w = torch.clamp(1.0 - torch.abs(d) / width, min=0.0)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    wsum = torch.sum(w, dim=-1, keepdim=True)
    w = w / torch.clamp(wsum, min=1e-8)
    row_valid = (i < valid_out[..., None, None]).to(w.dtype)
    return w * row_valid
