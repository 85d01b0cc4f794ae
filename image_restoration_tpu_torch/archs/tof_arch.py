"""TOFlow: task-oriented flow video SR.

Port of `image_restoration_tpu/archs/tof_arch.py`: `TOFBasicModule` (:22,
five 7×7 convs), `SPyNetTOF` (:38, the 4-level SpyNet: the flow upsampled
with `bilinear_ac` and doubled, the support frame warped with zero
padding) and `TOFlow` (:70: every frame warped to the reference frame, four
convs, the residual added to the reference). With
`adapt_official_weights` the frames are reordered [3, 0, 1, 2, 4, 5, 6]
and the reference frame is 0 (:77, 87). Input (N, 7, H, W, 3) in [0, 1]
(the ×4 bicubic-upscaled LRs), output the restored centre frame.

The port keeps the reference's BatchNorm after each bias-free conv of the
flow modules, where JAX folds them into the convs at import, so a BasicSR
`.pth` (`spynet.basic_module.N.basic_module.M`, convs at M = 0, 3, 6, 9,
12; `mean`/`std` buffers) loads strictly; in eval mode the pair is JAX's
folded conv.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, flow_warp
from .spynet_arch import MEAN, STD, avg_pool2


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the channels of NHWC."""

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TOFBasicModule(nn.Module):
    """Conv 7×7 (no bias), BN, ReLU ×4, then a conv with a bias to 2
    channels: 8 → 32 → 64 → 32 → 16 → 2."""

    def __init__(self):
        super().__init__()
        feats = (8, 32, 64, 32, 16, 2)
        layers = []
        for i in range(4):
            layers += [Conv(feats[i], feats[i + 1], 7, init="flax",
                            bias=False), BatchNorm2d(feats[i + 1]),
                       nn.ReLU()]
        layers.append(Conv(16, 2, 7, init="flax"))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SPyNetTOF(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(TOFBasicModule() for _ in range(4))

    def forward(self, ref, supp):
        """(ref, supp) normalized (N, H, W, 3), H and W multiples of 16 →
        flow (N, H, W, 2)."""
        n, h, w, _ = ref.shape
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, avg_pool2(refs[0]))
            supps.insert(0, avg_pool2(supps[0]))
        flow = ref.new_zeros(n, h // 16, w // 16, 2)
        for level in range(4):
            hh, ww = refs[level].shape[1:3]
            up = resize(flow, (hh, ww), "bilinear_ac") * 2.0
            warped = flow_warp(supps[level], up)
            flow = up + self.basic_module[level](
                torch.cat([refs[level], warped, up], dim=-1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    def __init__(self, adapt_official_weights: bool = False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1))
        self.spynet = SPyNetTOF()
        self.conv_1 = Conv(3 * 7, 64, 9, init="flax")
        self.conv_2 = Conv(64, 64, 9, init="flax")
        self.conv_3 = Conv(64, 64, 1, init="flax")
        self.conv_4 = Conv(64, 3, 1, init="flax")

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        mean = self.mean.view(3).to(lrs.dtype)
        std = self.std.view(3).to(lrs.dtype)
        lrs = (lrs - mean) / std
        lr_ref = lrs[:, self.ref_idx]
        warped = [lr_ref if i == self.ref_idx else
                  flow_warp(lrs[:, i], self.spynet(lr_ref, lrs[:, i]))
                  for i in range(lrs.shape[1])]
        feat = torch.relu(self.conv_1(torch.cat(warped, dim=-1)))
        feat = torch.relu(self.conv_3(torch.relu(self.conv_2(feat))))
        return (self.conv_4(feat) + lr_ref) * std + mean
