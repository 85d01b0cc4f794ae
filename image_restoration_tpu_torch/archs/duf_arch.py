"""DUF: video SR by dynamic upsampling filters.

Port of `image_restoration_tpu/archs/duf_arch.py`: 3-D convs over (N, T,
H, W, C) (`_conv3d` :27), BatchNorm with running statistics in eval mode
(`_BN` :35; eps 1e-3 with `adapt_official_weights`, else PyTorch's 1e-5,
:113-130), `DenseBlocks` (:68), `DenseBlocksTemporalReduce` (:89, each
block drops a frame at both ends), the per-pixel 5×5 filters applied to the
centre frame (`dynamic_upsampling_filter` :48: a shift stack and one
contraction) and `DUF` (:110, 16/28/52 layers). Input (N, 7, H, W, 3),
output the centre frame ×`scale`.

Parameters and BatchNorm buffers keep the reference's keys
(`dense_block1.dense_blocks.i.{0,2,3,5}`,
`dense_block2.temporal_reduce{1,2,3}.{0,2,3,5}`, `bn3d2`, …), so a BasicSR
`.pth` loads strictly. BatchNorm's momentum is the reference's (1e-3 with
the official weights, else 0.1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pixel_ops import pixel_shuffle
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv3d


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm over the channels of NTHWC (scale 1, bias 0, statistics
    0 and 1 at init, as flax's)."""

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1)


def _bn(c: int, official: bool) -> BatchNorm3d:
    return BatchNorm3d(c, eps=1e-3 if official else 1e-5,
                       momentum=1e-3 if official else 0.1)


def _dense_pair(c: int, grow: int, official: bool, pad_t: int):
    """BN, ReLU, 1×1×1 conv c→c, BN, ReLU, 3×3×3 conv c→grow (time padded
    `pad_t`), at the reference's indices 0–5."""
    return nn.Sequential(
        _bn(c, official), nn.ReLU(), Conv3d(c, c, (1, 1, 1)),
        _bn(c, official), nn.ReLU(),
        Conv3d(c, grow, (3, 3, 3), padding=(pad_t, 1, 1)))


class DenseBlocks(nn.Module):
    def __init__(self, num_block: int, num_feat: int = 64,
                 num_grow_ch: int = 16, adapt_official_weights=False):
        super().__init__()
        self.dense_blocks = nn.ModuleList(
            _dense_pair(num_feat + i * num_grow_ch, num_grow_ch,
                        adapt_official_weights, 1) for i in range(num_block))

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat([x, block(x)], dim=-1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 adapt_official_weights=False):
        super().__init__()
        for i in range(3):
            setattr(self, f"temporal_reduce{i + 1}", _dense_pair(
                num_feat + i * num_grow_ch, num_grow_ch,
                adapt_official_weights, 0))

    def forward(self, x):
        for i in range(3):
            y = getattr(self, f"temporal_reduce{i + 1}")(x)
            x = torch.cat([x[:, 1:-1], y], dim=-1)
        return x


def dynamic_upsampling_filter(x: torch.Tensor, filters: torch.Tensor,
                              filter_size=(5, 5)) -> torch.Tensor:
    """x (N, H, W, 3) through per-pixel filters (N, H, W, K, M), K the
    filter's taps (row-major), M = scale²: (N, H, W, 3·M) with channel
    c·M + m."""
    n, h, w, c = x.shape
    kh, kw = filter_size
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.stack([xp[:, dy:dy + h, dx:dx + w]
                           for dy in range(kh) for dx in range(kw)], dim=3)
    out = torch.einsum("nhwkc,nhwkm->nhwcm", patches, filters)
    return out.reshape(n, h, w, -1)


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    def __init__(self, scale: int = 4, num_layer: int = 52,
                 adapt_official_weights: bool = False):
        super().__init__()
        self.scale = scale
        if num_layer == 16:
            num_block, num_grow_ch = 3, 32
        elif num_layer == 28:
            num_block, num_grow_ch = 9, 16
        elif num_layer == 52:
            num_block, num_grow_ch = 21, 16
        else:
            raise ValueError(f"Only supported (16, 28, 52) layers, but got "
                             f"{num_layer}.")
        official = adapt_official_weights
        self.conv3d1 = Conv3d(3, 64, (1, 3, 3))
        self.dense_block1 = DenseBlocks(num_block, 64, num_grow_ch, official)
        c = 64 + num_grow_ch * num_block
        self.dense_block2 = DenseBlocksTemporalReduce(c, num_grow_ch,
                                                      official)
        c += num_grow_ch * 3
        self.bn3d2 = _bn(c, official)
        self.conv3d2 = Conv3d(c, 256, (1, 3, 3))
        self.conv3d_r1 = Conv3d(256, 256, (1, 1, 1))
        self.conv3d_r2 = Conv3d(256, 3 * scale ** 2, (1, 1, 1))
        self.conv3d_f1 = Conv3d(256, 512, (1, 1, 1))
        self.conv3d_f2 = Conv3d(512, 25 * scale ** 2, (1, 1, 1))

    def forward(self, x):
        n, t, h, w, _ = x.shape
        x_center = x[:, t // 2]
        feat = self.dense_block2(self.dense_block1(self.conv3d1(x)))
        feat = F.relu(self.conv3d2(F.relu(self.bn3d2(feat))))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(feat)))
        flt = self.conv3d_f2(F.relu(self.conv3d_f1(feat)))
        res = res[:, res.shape[1] // 2]
        flt = flt[:, flt.shape[1] // 2]
        flt = torch.softmax(flt.reshape(n, h, w, 25, self.scale ** 2), dim=3)
        out = dynamic_upsampling_filter(x_center, flt) + res
        return pixel_shuffle(out, self.scale)
