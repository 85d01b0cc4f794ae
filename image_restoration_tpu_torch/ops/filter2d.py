"""Per-sample 2D filtering and unsharp masking.

Port of `image_restoration_tpu/ops/filter2d.py`. `filter2d` correlates every
image of a batch with its own kernel (numpy's reflect padding of k//2, also
where k//2 reaches past the image, no kernel flip, as F.conv2d): the batch folds into the channel axis and one grouped
conv (groups = N·C) does the whole batch, with no loop over samples.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DeviceConstants


def _reflect_index(length: int, pad: int, device) -> torch.Tensor:
    """Source rows of numpy's "reflect" padding by `pad` on each side, which
    reflects again where `pad` reaches past the other edge (as `jnp.pad`
    does; F.pad's reflect refuses a pad of `length` or more)."""
    idx = torch.arange(-pad, length + pad, device=device)
    if length == 1:
        return torch.zeros_like(idx)
    period = 2 * (length - 1)
    idx = idx.abs() % period
    return torch.where(idx >= length, period - idx, idx)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., H, W) padded by `pad` on each side of both axes, numpy's
    "reflect" mode at any size."""
    h, w = x.shape[-2:]
    if pad < h and pad < w:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = x.index_select(-2, _reflect_index(h, pad, x.device))
    return x.index_select(-1, _reflect_index(w, pad, x.device))


def filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C); kernel: (N, kh, kw) per sample, or (kh, kw) shared."""
    n, h, w, c = x.shape
    if kernel.dim() == 2:
        kernel = kernel[None].expand(n, -1, -1)
    kh, kw = kernel.shape[1], kernel.shape[2]
    pad = kh // 2
    # (1, N·C, H, W), channel index n·C + c
    xr = x.permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    xp = reflect_pad(xr, pad)
    wk = kernel.to(x.dtype).repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(xp, wk, groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel-compatible 1D kernel (sigma<=0 → auto rule)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


# the 2D Gaussian of `usm_sharp` on a device, built once per (radius,
# dtype, device)
_usm_kernel = DeviceConstants(
    lambda radius, dtype, device: torch.as_tensor(
        np.outer(gaussian_kernel1d(radius), gaussian_kernel1d(radius)),
        dtype=dtype, device=device), maxsize=8)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: int = 10) -> torch.Tensor:
    """Unsharp masking of (N, H, W, C) images in [0, 1]."""
    if radius % 2 == 0:
        radius += 1
    k2 = _usm_kernel(radius, img.dtype, img.device)
    blur = filter2d(img, k2)
    residual = img - blur
    mask = (torch.abs(residual) * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d(mask, k2)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img
