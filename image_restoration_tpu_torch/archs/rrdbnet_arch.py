"""RRDBNet — the ESRGAN generator.

Port of `image_restoration_tpu/archs/rrdbnet_arch.py:30-113`: a 3×3 head
conv, `num_block` residual-in-residual dense blocks (three 5-conv dense
blocks each, residuals scaled by 0.2), a body conv with a global skip, two
nearest ×2 upsamples each followed by a conv and LeakyReLU(0.2), conv_hr and
conv_last. The ×2 and ×1 nets take a pixel-unshuffled input (by 2 and 4), so
every scale ends ×4 above its conv_first. NHWC at the forward.

Parameters keep the reference checkpoint's keys (`conv_first`,
`body.i.rdbK.convJ`, `conv_body`, `conv_up1`, `conv_up2`, `conv_hr`,
`conv_last`), so an ESRGAN `.pth` loads with `load_state_dict`. `dtype`
casts the input, and with it every conv and activation, as flax's does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pixel_ops import pixel_unshuffle
from ..ops.rrdb_common import lrelu, mul, nearest2x
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with a 0.2 residual scale."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        f, g = num_feat, num_grow_ch
        for j in range(1, 5):
            setattr(self, f"conv{j}", Conv(f + (j - 1) * g, g, scale=0.1))
        self.conv5 = Conv(f + 4 * g, f, scale=0.1)

    def forward(self, x):
        feats = [x]
        for j in range(1, 5):
            conv = getattr(self, f"conv{j}")
            feats.append(lrelu(conv(torch.cat(feats, -1))))
        x5 = self.conv5(torch.cat(feats, -1))
        return mul(x5, 0.2) + x


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return mul(self.rdb3(self.rdb2(self.rdb1(x))), 0.2) + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """ESRGAN generator: (N, H, W, C_in) → (N, H·scale, W·scale, C_out)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 scale: int = 4, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, dtype=None):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"RRDBNet scale must be 1, 2 or 4, got {scale}")
        self.scale, self.num_feat, self.num_block = scale, num_feat, num_block
        self.num_grow_ch, self.dtype = num_grow_ch, dtype
        cin = num_in_ch * {4: 1, 2: 4, 1: 16}[scale]
        self.conv_first = Conv(cin, num_feat)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = Conv(num_feat, num_feat)
        self.conv_up1 = Conv(num_feat, num_feat)
        self.conv_up2 = Conv(num_feat, num_feat)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, num_out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = lrelu(self.conv_up1(nearest2x(feat)))
        feat = lrelu(self.conv_up2(nearest2x(feat)))
        return self.conv_last(lrelu(self.conv_hr(feat)))
