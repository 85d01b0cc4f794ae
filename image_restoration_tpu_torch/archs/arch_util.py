"""Layers shared by the port's SR archs."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv3x3(nn.Conv2d):
    """3×3 SAME conv over NHWC, with the JAX package's init
    (`archs/arch_util.py` `conv_kaiming`): Kaiming normal (fan-in, gain √2)
    times `scale`, zero bias."""

    def __init__(self, cin: int, cout: int, scale: float = 1.0):
        self.init_scale = scale  # read by reset_parameters in __init__
        super().__init__(cin, cout, 3, padding=1)

    def reset_parameters(self, generator=None):
        std = self.init_scale * math.sqrt(2.0 / (self.in_channels * 9))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), padding=1)
        return y.permute(0, 2, 3, 1)
