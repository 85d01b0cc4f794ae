"""SRVGGNetCompact — Real-ESRGAN's compact VGG-style ×r SR net.

Port of `image_restoration_tpu/archs/srvgg_arch.py:25-63`: a stack of 3×3
convs each followed by an activation, a last conv to out·r² channels, pixel
shuffle, and a nearest-upsampled global skip. NHWC at the forward.

Parameters keep Real-ESRGAN's `body` layout, so its `.pth` loads with
`load_state_dict`: `body.{2i}` is conv i (i = 0 … num_conv), `body.{2i+1}`
its activation (PReLU holds `weight`, ReLU/LeakyReLU hold nothing) and
`body.{2(num_conv+1)}` is `conv_last`. The JAX module names the same tensors
`body_i`, `prelu_i` and `conv_last`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pixel_ops import pixel_shuffle
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv


class _PReLU(nn.PReLU):
    """Per-channel PReLU over the last axis, slope initialised to 0.25."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.weight.to(x.dtype))


class _Act(nn.Module):
    """Parameter-free ReLU or LeakyReLU(0.1)."""

    def __init__(self, act_type: str):
        super().__init__()
        self.act_type = act_type

    def forward(self, x):
        if self.act_type == "relu":
            return torch.relu(x)
        return torch.where(x >= 0, x, 0.1 * x)


@ARCH_REGISTRY.register()
class SRVGGNetCompact(nn.Module):

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_conv: int = 16, upscale: int = 4,
                 act_type: str = "prelu", dtype=None):
        super().__init__()
        if act_type not in ("prelu", "relu", "leakyrelu"):
            raise ValueError(f"unknown act_type {act_type!r}")
        self.num_conv, self.upscale, self.act_type = num_conv, upscale, act_type
        self.dtype = dtype
        layers = []
        for i in range(num_conv + 1):
            layers.append(Conv(num_in_ch if i == 0 else num_feat, num_feat))
            layers.append(_PReLU(num_feat) if act_type == "prelu"
                          else _Act(act_type))
        layers.append(Conv(num_feat, num_out_ch * upscale * upscale))
        self.body = nn.ModuleList(layers)

    def conv_layers(self):
        """[(weight OIHW, bias, PReLU slope or None)] of body convs 0 …
        num_conv, then conv_last with slope None."""
        b = self.body
        out = [(b[2 * i].weight, b[2 * i].bias,
                b[2 * i + 1].weight if self.act_type == "prelu" else None)
               for i in range(self.num_conv + 1)]
        return out + [(b[-1].weight, b[-1].bias, None)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) → (N, H·r, W·r, C_out)."""
        out = x if self.dtype is None else x.to(self.dtype)
        for layer in self.body:
            out = layer(out)
        out = pixel_shuffle(out, self.upscale)
        r = self.upscale
        base = x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
        return out + base
