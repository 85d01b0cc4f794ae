"""RIDNet, real image denoising with feature attention.

Port of `image_restoration_tpu/archs/ridnet_arch.py:29-120`:
`EResidualBlockNoBN` (conv, ReLU, conv, ReLU, 1×1 conv, plus the input,
ReLU), `MergeRun` (a 3×3 then dilation-2 branch beside a dilation-3 then
dilation-4 branch, merged by a conv, plus the input), `EAM` (MergeRun, a
residual block, the enhanced block and channel attention) and `RIDNet`
(head, `num_block` EAMs, tail, with a global skip). The input is in
[0, img_range]; it is shifted by `rgb_mean·img_range` and divided by
`rgb_std` before the head, and the tail's output is scaled back, as JAX
computes it (`ridnet_arch.py:109-119`). NHWC at the forward.

The convs keep JAX's inits: `conv_kaiming` where JAX calls it, flax's
default for the three dilated convs. Parameters keep the reference
checkpoint's keys (`head`, `body.i.merge.dilation{1,2}.{0,2}`,
`merge.aggregation.0`, `block1.conv{1,2}`, `block2.body.{0,2,4}`,
`ca.attention.{1,3}`, `tail`). The reference's two MeanShift 1×1 convs
(`sub_mean`, `add_mean`) are kept as fixed buffers, so a BasicSR `.pth`
loads strictly; the forward does not read them (JAX drops them on import,
`convert/torch_import.py:316`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.device import const_tensor
from ..utils.registry import ARCH_REGISTRY
from .arch_util import ChannelAttention, Conv, ResidualBlockNoBN
from .edsr_arch import RGB_MEAN


class MeanShift(nn.Module):
    """The reference's fixed 1×1 conv (weight I/std, bias
    sign·img_range·mean/std), as buffers that a checkpoint fills."""

    def __init__(self, img_range: float, rgb_mean, rgb_std, sign: int):
        super().__init__()
        std = torch.tensor(rgb_std, dtype=torch.float32)
        self.register_buffer("weight",
                             torch.eye(3).view(3, 3, 1, 1) / std.view(3, 1, 1, 1))
        self.register_buffer("bias", sign * img_range *
                             torch.tensor(rgb_mean, dtype=torch.float32) / std)


class EResidualBlockNoBN(nn.Module):
    """relu(body(x) + x), body = conv, ReLU, conv, ReLU, 1×1 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv(in_channels, out_channels), nn.ReLU(),
            Conv(out_channels, out_channels), nn.ReLU(),
            Conv(out_channels, out_channels, 1))

    def forward(self, x):
        return torch.relu(self.body(x) + x)


class MergeRun(nn.Module):
    """aggregation(cat(dilation1(x), dilation2(x))) + x."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.dilation1 = nn.Sequential(
            Conv(in_channels, c), nn.ReLU(),
            Conv(c, c, 3, dilation=2, init="flax"), nn.ReLU())
        self.dilation2 = nn.Sequential(
            Conv(in_channels, c, 3, dilation=3, init="flax"), nn.ReLU(),
            Conv(c, c, 3, dilation=4, init="flax"), nn.ReLU())
        self.aggregation = nn.Sequential(Conv(2 * c, c), nn.ReLU())

    def forward(self, x):
        return self.aggregation(torch.cat(
            [self.dilation1(x), self.dilation2(x)], dim=-1)) + x


class EAM(nn.Module):
    """MergeRun → relu(ResidualBlockNoBN) → EResidualBlockNoBN → channel
    attention."""

    def __init__(self, in_channels: int, mid_channels: int,
                 out_channels: int):
        super().__init__()
        self.merge = MergeRun(in_channels, mid_channels)
        self.block1 = ResidualBlockNoBN(mid_channels)
        self.block2 = EResidualBlockNoBN(mid_channels, out_channels)
        self.ca = ChannelAttention(out_channels)

    def forward(self, x):
        out = torch.relu(self.block1(self.merge(x)))
        return self.ca(self.block2(out))


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):
    """(N, H, W, C) in [0, img_range] → the denoised image, same shape."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 out_channels: int = 3, num_block: int = 4,
                 img_range: float = 255.0,
                 rgb_mean: Sequence[float] = RGB_MEAN,
                 rgb_std: Sequence[float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.img_range = img_range
        self.rgb_mean, self.rgb_std = tuple(rgb_mean), tuple(rgb_std)
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std, -1)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = Conv(in_channels, mid_channels)
        self.body = nn.Sequential(*[
            EAM(mid_channels, mid_channels, mid_channels)
            for _ in range(num_block)])
        self.tail = Conv(mid_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = const_tensor(self.rgb_mean, x.dtype, x.device) * self.img_range
        std = const_tensor(self.rgb_std, x.dtype, x.device)
        res = torch.relu(self.head((x - mean) / std))
        res = self.tail(self.body(res))
        return x + (res * std + mean)
