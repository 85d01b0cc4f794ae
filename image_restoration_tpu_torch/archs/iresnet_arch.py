"""ArcFace IResNet, the frozen embedder of the identity loss.

Port of `image_restoration_tpu/archs/iresnet_arch.py` (`IResNet`,
`IBasicBlock`, `IResNet18/34/50`): input (N, 112, 112, 3) in (−1, 1),
output (N, num_features).

The port keeps insightface's module names and layouts (`conv1`, `bn1`,
`prelu`, `layerL.B.{bn1,conv1,bn2,prelu,conv2,bn3,downsample.0,
downsample.1}`, `bn2`, `fc`, `features`), so an insightface `iresnetXX`
`state_dict` loads with `load_state_dict`. Two choices differ from the JAX
module, which gives the same function:

  * every BatchNorm is a `FrozenBatchNorm`: eval-mode BatchNorm with the
    checkpoint's running statistics, whatever `train()` says (JAX folds
    them into a `FoldedBN` scale/shift at import; the net is always
    frozen);
  * the net computes in NCHW inside, so `fc` reads the (C, H, W) flatten
    that insightface's `fc.weight` was trained on, and no permutation is
    needed (JAX flattens NHWC and permutes `fc` at import).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm over axis 1 that always uses its running statistics
    (also for the (N, C) `features` layer, BatchNorm1d in insightface)."""

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class _Conv(nn.Conv2d):
    """Bias-free NCHW conv, kaiming-normal (fan-in, gain √2) at init."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=k // 2, bias=False)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / self.weight[0].numel()),
                                generator=generator)


class _Linear(nn.Linear):
    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(1.0 / self.in_features),
                                generator=generator)
            self.bias.zero_()


class _PReLU(nn.PReLU):
    """Per-channel PReLU over axis 1, slope 0.25 at init."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x):
        a = self.weight.reshape(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, x * a)


class IBasicBlock(nn.Module):
    """bn1 → conv3×3 → bn2 → prelu → conv3×3(stride) → bn3, plus the
    shortcut (a 1×1 conv and BN where the shape changes)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = FrozenBatchNorm(inplanes, eps=1e-5)
        self.conv1 = _Conv(inplanes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes, eps=1e-5)
        self.prelu = _PReLU(planes)
        self.conv2 = _Conv(planes, planes, 3, stride)
        self.bn3 = FrozenBatchNorm(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                _Conv(inplanes, planes, 1, stride),
                FrozenBatchNorm(planes, eps=1e-5))

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        skip = x if self.downsample is None else self.downsample(x)
        return out + skip


@ARCH_REGISTRY.register()
class IResNet(nn.Module):
    """ArcFace IResNet; NHWC (N, 112, 112, 3) in (−1, 1) → (N,
    num_features)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_features: int = 512):
        super().__init__()
        self.conv1 = _Conv(3, 64, 3)
        self.bn1 = FrozenBatchNorm(64, eps=1e-5)
        self.prelu = _PReLU(64)
        inplanes = 64
        for li, blocks in enumerate(layers):
            planes = 64 * 2 ** li
            seq = [IBasicBlock(inplanes, planes, stride=2)]
            seq += [IBasicBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))
            inplanes = planes
        self.num_layers = len(layers)
        self.bn2 = FrozenBatchNorm(inplanes, eps=1e-5)
        self.fc = _Linear(inplanes * 7 * 7, num_features)
        self.features = FrozenBatchNorm(num_features, eps=1e-5)

    def forward(self, x):
        h = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        for li in range(self.num_layers):
            h = getattr(self, f"layer{li + 1}")(h)
        h = self.bn2(h)
        return self.features(self.fc(torch.flatten(h, 1)))


@ARCH_REGISTRY.register()
def IResNet18(**kw) -> IResNet:
    return IResNet(layers=(2, 2, 2, 2), **kw)


@ARCH_REGISTRY.register()
def IResNet34(**kw) -> IResNet:
    return IResNet(layers=(3, 4, 6, 3), **kw)


@ARCH_REGISTRY.register()
def IResNet50(**kw) -> IResNet:
    return IResNet(layers=(3, 4, 14, 3), **kw)
