"""InceptionV3, the FID variant: NHWC images in, pooled 2048-d features out.

Port of `image_restoration_tpu/archs/inception_arch.py:29-218` (BasicSR's
pt_inception FID net): torchvision's InceptionV3 block layout with the FID
pooling patches. The pool branch of blocks A, C and E_1 is an average pool
that leaves the zero padding out of its divisor (`count_include_pad=False`),
Mixed_7c takes a max pool there, the two stride-2 max pools of the stem and
of blocks B and D are VALID, and BatchNorm's eps is 1e-3. Modules carry
torchvision's / pt_inception's key names (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_mean`, ...), so a pt_inception `.pth` loads
with `load_state_dict` once its `fc.*` and `AuxLogits.*` entries are
dropped (`metrics/fid.py`). The net always runs in inference form: its
BatchNorms use their running statistics. The 299² input resize is the
port's `ops/resize.resize` (cv2's bilinear matrix), as JAX's is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .iresnet_arch import FrozenBatchNorm


class _Conv(nn.Conv2d):
    """Bias-free conv, kaiming-normal (fan-in, gain √2) at init, so a random
    net keeps its activations' scale through the ReLUs."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / self.weight[0].numel()),
                                generator=generator)


class BasicConv2d(nn.Module):
    """conv (no bias) → BatchNorm (eps 1e-3, running statistics) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size=1, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = _Conv(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64)
        self.branch5x5_1 = BasicConv2d(cin, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192)
        self.branch7x7_1 = BasicConv2d(cin, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2,
                      self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """Mixed_7b (`pool_max=False`: the average pool) and Mixed_7c
    (`pool_max=True`: BasicSR's FIDInceptionE_2 max pool)."""

    def __init__(self, cin: int, pool_max: bool = False):
        super().__init__()
        self.pool_max = pool_max
        self.branch1x1 = BasicConv2d(cin, 320)
        self.branch3x3_1 = BasicConv2d(cin, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_max else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


@ARCH_REGISTRY.register()
class InceptionV3(nn.Module):
    """FID feature extractor: NHWC RGB in [0, 1] (resized to 299² unless
    `resize_input` is off, mapped to [−1, 1] by 2x − 1 unless
    `normalize_input` is off) → (N, 2048) average-pooled features."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_max=True)

    def forward(self, x):
        if self.resize_input and x.shape[1:3] != (299, 299):
            x = resize(x, (299, 299), "bilinear")  # 299² → 299² is identity
        if self.normalize_input:
            x = 2 * x - 1
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))
