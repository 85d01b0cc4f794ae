"""MSRResNet, the modified SRResNet (and MSRGAN's generator).

Port of `image_restoration_tpu/archs/srresnet_arch.py:28-61`: conv_first,
`num_block` residual blocks without BN, a pixel-shuffle head (one ×2 or ×3
stage, or two ×2 stages for ×4), conv_hr and conv_last, all after
LeakyReLU(0.1), plus the input resized bilinearly (cv2's half-pixel
bilinear, `ops.resize.resize`) as a global skip. NHWC at the forward.

Parameters keep the reference checkpoint's keys (`conv_first`,
`body.i.conv1`, `upconv1`, `upconv2`, `conv_hr`, `conv_last`), so a BasicSR
`.pth` loads with `load_state_dict`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pixel_ops import pixel_shuffle
from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, ResidualBlockNoBN


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):
    """(N, H, W, C_in) → (N, H·upscale, W·upscale, C_out), upscale 2, 3 or
    4."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 16, upscale: int = 4):
        super().__init__()
        if upscale not in (2, 3, 4):
            raise ValueError(f"MSRResNet upscale must be 2, 3 or 4, got "
                             f"{upscale}")
        self.upscale = upscale
        self.conv_first = Conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat)
                                    for _ in range(num_block)])
        if upscale == 4:
            self.upconv1 = Conv(num_feat, num_feat * 4)
            self.upconv2 = Conv(num_feat, num_feat * 4)
        else:
            self.upconv1 = Conv(num_feat, num_feat * upscale ** 2)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, num_out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.body(_lrelu(self.conv_first(x)))
        if self.upscale == 4:
            out = _lrelu(pixel_shuffle(self.upconv1(out), 2))
            out = _lrelu(pixel_shuffle(self.upconv2(out), 2))
        else:
            out = _lrelu(pixel_shuffle(self.upconv1(out), self.upscale))
        out = self.conv_last(_lrelu(self.conv_hr(out)))
        h, w = x.shape[1], x.shape[2]
        return out + resize(x, (h * self.upscale, w * self.upscale),
                            "bilinear")
