"""EDSR.

Port of `image_restoration_tpu/archs/edsr_arch.py:17-44`: the input shifted
by the RGB mean and scaled to `img_range`, conv_first, `num_block` residual
blocks without BN (each residual times `res_scale`; EDSR-L is 256 features,
32 blocks, res_scale 0.1), conv_after_body with a skip, the pixel-shuffle
`Upsample` and conv_last, then the shift undone. NHWC at the forward.

Parameters keep the reference checkpoint's keys (`conv_first`,
`body.i.conv{1,2}`, `conv_after_body`, `upsample.{0,2}`, `conv_last`); the
reference's mean is no parameter, so a BasicSR `.pth` loads strictly.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.device import const_tensor
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, ResidualBlockNoBN, Upsample

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@ARCH_REGISTRY.register()
class EDSR(nn.Module):
    """(N, H, W, C_in) → (N, H·upscale, W·upscale, C_out), upscale 2^n or
    3."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4,
                 res_scale: float = 1.0, img_range: float = 255.0,
                 rgb_mean: Sequence[float] = RGB_MEAN):
        super().__init__()
        self.img_range, self.rgb_mean = img_range, tuple(rgb_mean)
        self.conv_first = Conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat, res_scale)
                                    for _ in range(num_block)])
        self.conv_after_body = Conv(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = Conv(num_feat, num_out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = const_tensor(self.rgb_mean, x.dtype, x.device)
        feat = self.conv_first((x - mean) * self.img_range)
        res = self.conv_after_body(self.body(feat)) + feat
        out = self.conv_last(self.upsample(res))
        return out / self.img_range + mean
