"""Layers shared by the port's SR archs.

Port of `image_restoration_tpu/archs/arch_util.py:24-94`: the conv with
JAX's inits, `ResidualBlockNoBN` and the pixel-shuffle `Upsample`. Every
layer takes and returns NHWC; a conv runs on the NCHW view. `Upsample` is a
Sequential with the reference's indices (`upsample.0`, `upsample.2`, …), so
a BasicSR checkpoint's keys land as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pixel_ops import pixel_shuffle

# std of a standard normal truncated at ±2 (flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float, generator=None):
    """w ← N(0, std²) truncated at ±2·std, by redrawing the values outside
    (about 5%) until none is: the distribution of `nn.init.trunc_normal_`
    at a fraction of its cost (it inverts the CDF of every value)."""
    w.normal_(0.0, 1.0, generator=generator)
    while True:
        out = w.abs() > 2.0
        n = int(out.sum())
        if n == 0:
            break
        w[out] = torch.randn(n, generator=generator, dtype=w.dtype)
    return w.mul_(std)


class Conv(nn.Conv2d):
    """k×k stride-1 conv over NHWC, padded (k // 2)·dilation (SAME), with
    one of three inits, drawn from the generator `build_network` passes:
    "kaiming", JAX's `conv_kaiming` (Kaiming normal, fan-in, gain √2, times
    `scale`); "flax", a plain flax `nn.Conv` (LeCun normal truncated at
    2σ); both with a zero bias; or "torch", PyTorch's own `nn.Conv2d` init
    (weight and bias uniform in ±1/√fan_in), which the reference's RCAN
    keeps. Left uninitialized until `reset_parameters(generator)`, which
    `build_network` calls."""

    def __init__(self, cin: int, cout: int, k: int = 3, scale: float = 1.0,
                 dilation: int = 1, init: str = "kaiming"):
        if init not in ("kaiming", "flax", "torch"):
            raise ValueError(f"unknown init {init!r}")
        self.init_scale, self.init = scale, init  # read by reset_parameters
        super().__init__(cin, cout, k, padding=(k // 2) * dilation,
                         dilation=dilation)

    def reset_parameters(self, generator=None):
        if generator is None:  # nn.Conv2d.__init__'s own call
            return
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            if self.init == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                self.weight.uniform_(-bound, bound, generator=generator)
                self.bias.uniform_(-bound, bound, generator=generator)
                return
            if self.init == "flax":
                trunc_normal_(self.weight,
                              math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)
            else:
                std = self.init_scale * math.sqrt(2.0 / fan_in)
                self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), padding=self.padding,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x)))·res_scale, both convs at Kaiming × 0.1
    (JAX `arch_util.py:52-69`)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(num_feat, num_feat, 3, scale=0.1)
        self.conv2 = Conv(num_feat, num_feat, 3, scale=0.1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x))) * self.res_scale


class PixelShuffle(nn.Module):
    """(N, H, W, C·r²) → (N, H·r, W·r, C) in torch's channel order."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return pixel_shuffle(x, self.scale)


class Upsample(nn.Sequential):
    """conv(c → 4c) + shuffle ×2 per factor of 2, or conv(c → 9c) + shuffle
    ×3 (JAX `arch_util.py:72-94`); the convs sit at the even indices and
    take `init`."""

    def __init__(self, scale: int, num_feat: int, init: str = "kaiming"):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [Conv(num_feat, 4 * num_feat, init=init),
                           PixelShuffle(2)]
        elif scale == 3:
            layers += [Conv(num_feat, 9 * num_feat, init=init),
                       PixelShuffle(3)]
        else:
            raise ValueError(f"unsupported upsample scale {scale}")
        super().__init__(*layers)


class ChannelAttention(nn.Module):
    """x·sigmoid(fc2(relu(fc1(mean over H, W)))), the 1×1 convs at `init`;
    the reference's Sequential (pool, conv, relu, conv, sigmoid) keeps its
    indices, so the convs are `attention.1` and `attention.3`."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16,
                 init: str = "kaiming"):
        super().__init__()
        c = num_feat // squeeze_factor
        self.attention = nn.Sequential(
            GlobalAvgPool(), Conv(num_feat, c, 1, init=init), nn.ReLU(),
            Conv(c, num_feat, 1, init=init), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class GlobalAvgPool(nn.Module):
    """Mean over H and W of NHWC, kept as a 1×1 map."""

    def forward(self, x):
        return x.mean(dim=(1, 2), keepdim=True)
