"""PSNR / SSIM.

Port of `image_restoration_tpu/metrics/psnr_ssim.py`. The host versions
the validation calls (:23-78): numpy float64 on HWC images in [0, 255],
`crop_border`, `test_y_channel`; SSIM with an 11×11 σ=1.5 window per
channel. The batch versions (:83-110), `psnr_batch` and `ssim_batch`, take
NHWC tensors in [0, max_val] and score each sample on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DeviceConstants
from ..utils.registry import METRIC_REGISTRY
from .metric_util import reorder_image, to_y_channel


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    assert img.shape == img2.shape
    img = reorder_image(np.asarray(img), input_order).astype(np.float64)
    img2 = reorder_image(np.asarray(img2), input_order).astype(np.float64)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img, img2 = to_y_channel(img), to_y_channel(img2)
    return img, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border: int, input_order: str = "HWC",
                   test_y_channel: bool = False, **kwargs) -> float:
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _ssim_single(img: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM on [0,255] float64. The 11×11 Gaussian window
    is the outer product of its 1-D kernel, so each filter runs as two
    1-D passes (`cv2.sepFilter2D`): the interior JAX's `cv2.filter2D`
    keeps, to float64 rounding, at 22 instead of 121 products a pixel."""
    import cv2
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    kernel = cv2.getGaussianKernel(11, 1.5)

    def blur(a):
        return cv2.sepFilter2D(a, -1, kernel, kernel)[5:-5, 5:-5]

    mu1 = blur(img)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = blur(img ** 2) - mu1_sq
    sigma2_sq = blur(img2 ** 2) - mu2_sq
    sigma12 = blur(img * img2) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border: int, input_order: str = "HWC",
                   test_y_channel: bool = False, **kwargs) -> float:
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    return float(np.mean([_ssim_single(img[..., i], img2[..., i])
                          for i in range(img.shape[2])]))


# ------------------------------------------------------ batch (on device)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


# the 11×11 window as a (1, 1, 11, 11) conv weight, once per device/dtype
_window = DeviceConstants(
    lambda device, dtype: torch.as_tensor(
        _gaussian_window(), dtype=dtype, device=device)[None, None],
    maxsize=16)


def psnr_batch(pred: torch.Tensor, gt: torch.Tensor,
               max_val: float = 1.0) -> torch.Tensor:
    """(N,) PSNR of NHWC batches in [0, max_val], the MSE floored at 1e-12
    (JAX :83-86)."""
    mse = torch.mean((pred - gt) ** 2, dim=(1, 2, 3))
    return 20.0 * torch.log10(max_val / torch.sqrt(
        torch.clamp(mse, min=1e-12)))


def ssim_batch(pred: torch.Tensor, gt: torch.Tensor,
               max_val: float = 1.0) -> torch.Tensor:
    """(N,) SSIM of NHWC batches (JAX :89-110): the 11×11 σ=1.5 window as
    one depthwise VALID conv per statistic, the map's mean per sample."""
    c = pred.shape[-1]
    w = _window(pred.device, pred.dtype).expand(c, 1, -1, -1)

    def f(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w, groups=c)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu1, mu2 = f(pred), f(gt)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = f(pred ** 2) - mu1_sq
    s2 = f(gt ** 2) - mu2_sq
    s12 = f(pred * gt) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map, dim=(1, 2, 3))
