"""LPIPS perceptual distance over the port's VGG16.

Port of `image_restoration_tpu/metrics/lpips.py:34-123` (the `lpips`
package's `LPIPS(net='vgg')`): RGB inputs in [-1, 1], the package's
ScalingLayer shift and scale, VGG16 features at relu{1_2, 2_2, 3_3, 4_3,
5_3}, each unit-normalized over its channels, the squared difference
weighted by the learned non-negative 1×1 "lin" weights, its spatial mean,
summed over the five taps.

The lin weights (an lpips checkpoint, e.g. `lpips/weights/v0.1/vgg.pth`:
`lin{i}.model.1.weight` of shape (1, C, 1, 1)) and the VGG16 weights (a
torchvision vgg16 `state_dict`, `features.N` keys) are data from outside the
repository. Without them the distance uses uniform lin weights (the
channel mean) over a VGG16 drawn from seed 0: well defined, not calibrated
LPIPS, and a warning says so once.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import METRIC_REGISTRY

_TAPS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
# lpips.ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """`LPIPS()(img, img2)`: NHWC (or HWC) RGB tensors in [-1, 1] → the
    per-image distance (N,) (or a scalar)."""

    def __init__(self, lpips_weights_path: Optional[str] = None,
                 vgg_weights_path: Optional[str] = None):
        super().__init__()
        from ..archs import build_network
        self.net = build_network(dict(
            type="VGGFeatureExtractor", layer_name_list=_TAPS,
            vgg_type="vgg16", use_input_norm=False, range_norm=False))
        if vgg_weights_path:
            self.net.load_torchvision(vgg_weights_path)
        self.uniform = not lpips_weights_path
        if lpips_weights_path:
            sd = torch.load(lpips_weights_path, map_location="cpu",
                            weights_only=True)
            for i in range(len(_TAPS)):
                self.register_buffer(
                    f"lin{i}", sd[f"lin{i}.model.1.weight"].reshape(-1)
                    .float())
        if not (lpips_weights_path and vgg_weights_path):
            warnings.warn(
                "LPIPS running without calibrated weights (pass "
                "lpips_weights_path= and vgg_weights_path=); values are "
                "self-consistent but not comparable to published LPIPS.",
                stacklevel=2)
        self.register_buffer("shift", torch.tensor(_SHIFT))
        self.register_buffer("scale", torch.tensor(_SCALE))
        self.eval().requires_grad_(False)

    def forward(self, img: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        squeeze = img.dim() == 3
        if squeeze:
            img, img2 = img[None], img2[None]
        n = img.shape[0]
        x = (torch.cat([img, img2]).float() - self.shift) / self.scale
        feats = self.net(x)
        total = 0.0
        for i, tap in enumerate(_TAPS):
            f = feats[tap]
            f = f / torch.sqrt((f ** 2).sum(-1, keepdim=True) + 1e-10)
            d2 = (f[:n] - f[n:]) ** 2
            d = d2.mean(-1) if self.uniform else \
                (d2 * getattr(self, f"lin{i}")).sum(-1)
            total = total + d.mean(dim=(-2, -1))
        return total[0] if squeeze else total


@functools.lru_cache(maxsize=4)
def _lpips(lpips_weights_path, vgg_weights_path, device) -> LPIPS:
    return LPIPS(lpips_weights_path, vgg_weights_path).to(device)


@METRIC_REGISTRY.register()
def calculate_lpips(img, img2, crop_border: int = 0,
                    lpips_weights_path: Optional[str] = None,
                    vgg_weights_path: Optional[str] = None, device=None,
                    **kwargs) -> float:
    """Registered metric: img, img2 are HWC BGR images in [0, 255] (the
    repo's metric convention), taken to RGB [-1, 1]; the net runs on
    `device` (None: cuda) and is built once per weights and device."""
    dev = resolve_device(device)
    fn = _lpips(lpips_weights_path, vgg_weights_path, str(dev))
    a = np.asarray(img, np.float32)[..., ::-1] / 255.0 * 2 - 1
    b = np.asarray(img2, np.float32)[..., ::-1] / 255.0 * 2 - 1
    if crop_border:
        a = a[crop_border:-crop_border, crop_border:-crop_border]
        b = b[crop_border:-crop_border, crop_border:-crop_border]
    with torch.inference_mode():
        d = fn(torch.from_numpy(a.copy()).to(dev),
               torch.from_numpy(b.copy()).to(dev))
    return float(d)
