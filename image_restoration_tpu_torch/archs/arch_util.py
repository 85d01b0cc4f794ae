"""Layers shared by the port's SR and video archs.

Port of `image_restoration_tpu/archs/arch_util.py`: the conv with JAX's
inits (and its 3-D twin for DUF), `ResidualBlockNoBN`, the pixel-shuffle
`Upsample`, and `flow_warp` / `resize_flow` (JAX `:98-229`). Every layer
takes and returns NHWC (NTHWC for the 3-D conv); a conv runs on the
NCHW (NCTHW) view. `Upsample` is a Sequential with the reference's indices
(`upsample.0`, `upsample.2`, …), so a BasicSR checkpoint's keys land as
they are.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pixel_ops import pixel_shuffle
from ..ops.resize import resize

# std of a standard normal truncated at ±2 (flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float, generator=None):
    """w ← N(0, std²) truncated at ±2·std, by redrawing the values outside
    (about 5%) until none is: the distribution of `nn.init.trunc_normal_`
    at a fraction of its cost (it inverts the CDF of every value)."""
    if w.is_meta:  # no values to draw
        return w
    w.normal_(0.0, 1.0, generator=generator)
    while True:
        out = w.abs() > 2.0
        n = int(out.sum())
        if n == 0:
            break
        w[out] = torch.randn(n, generator=generator, dtype=w.dtype)
    return w.mul_(std)


@torch.no_grad()
def init_conv_(conv, init: str, scale: float, generator) -> None:
    """Draw a conv's weight (and bias, when it has one) with one of the
    three inits `Conv` names."""
    fan_in = conv.weight[0].numel()
    if init == "torch":
        bound = 1.0 / math.sqrt(fan_in)
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
        return
    if init == "flax":
        trunc_normal_(conv.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                      generator)
    else:
        conv.weight.normal_(0.0, scale * math.sqrt(2.0 / fan_in),
                            generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()


class Conv(nn.Conv2d):
    """k×k conv over NHWC, padded (k // 2)·dilation (SAME at stride 1), with
    one of three inits, drawn from the generator `build_network` passes:
    "kaiming", JAX's `conv_kaiming` (Kaiming normal, fan-in, gain √2, times
    `scale`); "flax", a plain flax `nn.Conv` (LeCun normal truncated at
    2σ); both with a zero bias; or "torch", PyTorch's own `nn.Conv2d` init
    (weight and bias uniform in ±1/√fan_in), which the reference's RCAN
    keeps. Left uninitialized until `reset_parameters(generator)`, which
    `build_network` calls."""

    def __init__(self, cin: int, cout: int, k: int = 3, scale: float = 1.0,
                 dilation: int = 1, init: str = "kaiming", stride: int = 1,
                 bias: bool = True):
        if init not in ("kaiming", "flax", "torch"):
            raise ValueError(f"unknown init {init!r}")
        self.init_scale, self.init = scale, init  # read by reset_parameters
        super().__init__(cin, cout, k, stride=stride,
                         padding=(k // 2) * dilation, dilation=dilation,
                         bias=bias)

    def reset_parameters(self, generator=None):
        if generator is not None:  # not nn.Conv2d.__init__'s own call
            init_conv_(self, self.init, self.init_scale, generator)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias,
                     stride=self.stride, padding=self.padding,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """(kt, kh, kw) conv over NTHWC with flax's default init (JAX
    `duf_arch.py:27` `_conv3d`), padded `padding` (default k // 2 on each
    axis)."""

    def __init__(self, cin: int, cout: int, k: Sequence[int],
                 padding: Optional[Sequence[int]] = None):
        super().__init__(cin, cout, tuple(k), padding=tuple(
            kk // 2 for kk in k) if padding is None else tuple(padding))

    def reset_parameters(self, generator=None):
        if generator is not None:
            init_conv_(self, "flax", 1.0, generator)

    def forward(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


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


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear", padding_mode: str = "zeros",
              max_flow: Optional[int] = None) -> torch.Tensor:
    """Warp NHWC `x` by the flow (N, H, W, 2) = (Δx, Δy): the sample of
    pixel (i, j) is x at (i + Δy, j + Δx), bilinear or nearest (round half
    to even), outside the map zero ("zeros") or the edge ("border"): torch
    `grid_sample` with `align_corners=True` (JAX `arch_util.py:98`).
    `max_flow=R` clamps the flow to ±R first, the meaning of JAX's
    windowed path (`_flow_warp_windowed`, `:154`). It is one `grid_sample`
    on the NCHW view, the reference's own form, and JAX's gather path on
    the CPU tests' inputs within rounding."""
    n, h, w, _ = x.shape
    if max_flow is not None:
        flow = flow.clamp(-max_flow, max_flow)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    vx = (gx + flow[..., 0]) * (2.0 / max(w - 1, 1)) - 1.0
    vy = (gy + flow[..., 1]) * (2.0 / max(h - 1, 1)) - 1.0
    out = F.grid_sample(x.permute(0, 3, 1, 2), torch.stack((vx, vy), -1),
                        mode=interp_mode, padding_mode=padding_mode,
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def resize_flow(flow: torch.Tensor, size_type: str, sizes,
                interp_mode: str = "bilinear") -> torch.Tensor:
    """Resize a flow (N, H, W, 2) by a ratio or to a shape and scale its
    values with the size (JAX `arch_util.py:231`)."""
    n, h, w, _ = flow.shape
    if size_type == "ratio":
        oh, ow = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        oh, ow = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f"unknown size_type {size_type}")
    out = resize(flow, (oh, ow), interp_mode)
    return out * torch.tensor([ow / w, oh / h], dtype=flow.dtype,
                              device=flow.device)
