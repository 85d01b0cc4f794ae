"""SpyNet optical flow.

Port of `image_restoration_tpu/archs/spynet_arch.py` (`BasicModule` :24,
`_avg_pool2` :39, `SpyNet` :45): inputs normalized by ImageNet's mean and
std, a 6-level pyramid of 2×2 average pools, and at each level the flow
upsampled ×2 (`bilinear_ac`, torch's align_corners=True) and doubled, the
support frame warped by it (border padding), and a 5-conv 7×7 module
refining it; the input is resized to multiples of 32 first and the flow
back to the input's size and scale. NHWC at the forward; the flow is
(N, H, W, 2) = (Δx, Δy).

Parameters keep the reference's keys (`basic_module.N.basic_module.M`,
convs at M = 0, 2, 4, 6, 8; the `mean`/`std` buffers), so a BasicSR `.pth`
loads strictly. `load_path` loads one after `build_network` draws the
weights (`load_pretrained`); a path that is given but missing raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..convert.pth import load_pth
from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, flow_warp

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 mean of NHWC (JAX `_avg_pool2`)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class BasicModule(nn.Module):
    """Five 7×7 convs 8 → 32 → 64 → 32 → 16 → 2 with ReLUs between, at the
    reference's Sequential indices."""

    def __init__(self):
        super().__init__()
        feats = (8, 32, 64, 32, 16, 2)
        layers = []
        for i in range(5):
            layers.append(Conv(feats[i], feats[i + 1], 7, init="flax"))
            if i < 4:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


def load_pretrained_path(net: nn.Module, path: Optional[str]) -> None:
    """Load a reference `.pth`'s `params` into `net` strictly, if a path is
    given (FileNotFoundError when it is missing)."""
    if path:
        net.load_state_dict(load_pth(path, "params"), strict=True)


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    """(ref, supp) (N, H, W, 3) in [0, 1] → flow (N, H, W, 2)."""

    def __init__(self, load_path: Optional[str] = None):
        super().__init__()
        self.load_path = load_path
        self.basic_module = nn.ModuleList(BasicModule() for _ in range(6))
        self.register_buffer("mean", torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(STD).view(1, 3, 1, 1))

    def load_pretrained(self):
        load_pretrained_path(self, self.load_path)

    def _normalize(self, x):
        return (x - self.mean.view(3).to(x.dtype)) / self.std.view(3).to(
            x.dtype)

    def process(self, ref, supp):
        refs, supps = [self._normalize(ref)], [self._normalize(supp)]
        for _ in range(5):
            refs.insert(0, avg_pool2(refs[0]))
            supps.insert(0, avg_pool2(supps[0]))
        n, h0, w0 = ref.shape[0], refs[0].shape[1] // 2, refs[0].shape[2] // 2
        flow = ref.new_zeros(n, h0, w0, 2)
        for level in range(6):
            h, w = refs[level].shape[1:3]
            up = resize(flow, (h, w), "bilinear_ac") * 2.0
            warped = flow_warp(supps[level], up, padding_mode="border")
            flow = self.basic_module[level](
                torch.cat([refs[level], warped, up], dim=-1)) + up
        return flow

    def forward(self, ref, supp):
        h, w = ref.shape[1:3]
        h32 = int(math.ceil(h / 32.0) * 32)
        w32 = int(math.ceil(w / 32.0) * 32)
        flow = self.process(resize(ref, (h32, w32), "bilinear"),
                            resize(supp, (h32, w32), "bilinear"))
        flow = resize(flow, (h, w), "bilinear")
        return flow * torch.tensor([w / w32, h / h32], dtype=flow.dtype,
                                   device=flow.device)
