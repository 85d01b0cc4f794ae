"""RCAN, the residual channel-attention network.

Port of `image_restoration_tpu/archs/rcan_arch.py:21-102`: `ChannelAttention`
(a global mean, two 1×1 convs, a sigmoid gate), `RCAB` (conv, ReLU, conv,
attention, plus the input), `ResidualGroup` (`num_block` RCABs and a conv,
plus the input) and `RCAN` (EDSR's mean shift, head, `num_group` groups,
conv_after_body with a skip, the pixel-shuffle `Upsample`, conv_last). NHWC
at the forward.

Parameters keep the reference checkpoint's keys: the groups'
`body.G.residual_group.B.rcab.{0,2}` convs, the attention's
`rcab.3.attention.{1,3}`, `body.G.conv`, `upsample.{0,2}`; so a BasicSR
`.pth` loads strictly.

Every conv is drawn with PyTorch's own `nn.Conv2d` init, as the
reference's RCAN is, not JAX's `conv_kaiming`: under Kaiming's gain √2
each RCAB adds a residual about half the stream's variance, so 10 groups
of 20 put the untrained output near 1e29 and the L1 step of
`train_RCAN_x2.yml` diverges (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.device import const_tensor
from ..utils.registry import ARCH_REGISTRY
from .arch_util import ChannelAttention, Conv, Upsample
from .edsr_arch import RGB_MEAN


def _conv(cin, cout):
    return Conv(cin, cout, 3, init="torch")


class RCAB(nn.Module):
    """x + (conv, ReLU, conv, channel attention)(x)·res_scale."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(
            _conv(num_feat, num_feat), nn.ReLU(), _conv(num_feat, num_feat),
            ChannelAttention(num_feat, squeeze_factor, init="torch"))

    def forward(self, x):
        return x + self.rcab(x) * self.res_scale


class ResidualGroup(nn.Module):
    """x + conv(RCAB × num_block (x))."""

    def __init__(self, num_feat: int, num_block: int,
                 squeeze_factor: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.residual_group = nn.Sequential(*[
            RCAB(num_feat, squeeze_factor, res_scale)
            for _ in range(num_block)])
        self.conv = _conv(num_feat, num_feat)

    def forward(self, x):
        return x + self.conv(self.residual_group(x))


@ARCH_REGISTRY.register()
class RCAN(nn.Module):
    """(N, H, W, C_in) → (N, H·upscale, W·upscale, C_out), upscale 2^n or
    3."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_group: int = 10,
                 num_block: int = 16, squeeze_factor: int = 16,
                 upscale: int = 4, res_scale: float = 1.0,
                 img_range: float = 255.0,
                 rgb_mean: Sequence[float] = RGB_MEAN):
        super().__init__()
        self.img_range, self.rgb_mean = img_range, tuple(rgb_mean)
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[
            ResidualGroup(num_feat, num_block, squeeze_factor, res_scale)
            for _ in range(num_group)])
        self.conv_after_body = _conv(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat, init="torch")
        self.conv_last = _conv(num_feat, num_out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = const_tensor(self.rgb_mean, x.dtype, x.device)
        feat = self.conv_first((x - mean) * self.img_range)
        res = self.conv_after_body(self.body(feat)) + feat
        out = self.conv_last(self.upsample(res))
        return out / self.img_range + mean
