"""RetinaFace-style licence-plate detector — PyTorch, NHWC at the forward.

Port of `image_restoration_tpu/archs/retinaface_arch.py`: a ResNet-18/50,
MobileNetV1-0.25 or MobileNetV3 trunk with three taps at strides 8/16/32,
FPN, three SSH blocks, and per-level 1×1 Bbox/Class/Landmark heads with 2
anchors; softmax over the classes in the test phase. BatchNorm runs in its
eval form (running statistics, eps 1e-5) in eval mode, and as flax's
training BatchNorm in train mode (`BN`), which the detector trainer uses.

Parameters keep the reference checkpoint's names (Plate_Detect/
Retina-License-Plate/models/{retinaface.py,net.py}), which is what
`convert/retinaface_import.py` maps: torchvision names for the ResNet bodies
(`body.layer2.0.downsample.0.weight`), Sequential indices for MobileNetV1
(`body.stage2.3.4.running_var`), FPN and SSH (`fpn.output1.0.weight`,
`ssh1.conv3X3.1.bias`) and the heads (`ClassHead.0.conv1x1.weight`). The
reference's MobileNetV3 is dead code, so that trunk's keys are the JAX
module names (`body.block0_pw1.weight`, `body.stem_bn.running_mean`).

FPN's upsample where the ratio is not an integer (80² input: 3 → 5) is
`jax.image.resize(..., "nearest")`, which samples at half-pixel centres:
`F.interpolate(mode="nearest-exact")`, not the reference's "nearest".
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dist_util import in_world, world_mean
from ..utils.registry import ARCH_REGISTRY

# (out channels, stride, expansion) of the MobileNetV3 blocks; taps after
# blocks 3, 5 and 7
_V3_BLOCKS = ((24, 2, 4), (24, 1, 3), (128, 2, 3), (128, 1, 3),
              (256, 2, 3), (256, 1, 3), (512, 2, 3), (512, 1, 3))


class Conv(nn.Conv2d):
    """Conv over NCHW with flax's default init (LeCun normal, zero bias)
    drawn from an explicit generator; weights cast to the input's dtype."""

    def reset_parameters(self, generator=None):
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype))


class BN(nn.BatchNorm2d):
    """BatchNorm2d over NCHW, eps 1e-5, as flax's `nn.BatchNorm(momentum=
    0.9)`.

    In eval mode it normalizes with the running statistics. In train mode
    it normalizes with the batch's mean and biased variance (one fused
    `F.batch_norm` without running buffers, forward and backward) and moves
    the running statistics itself, running ← 0.9·running + 0.1·batch with
    the biased variance again: `F.batch_norm` would move them with the
    unbiased variance."""

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        dt = x.dtype
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(dt),
                                self.running_var.to(dt), self.weight.to(dt),
                                self.bias.to(dt), False, 0.0, self.eps)
        if in_world():
            return self._world_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), 0.1)
            self.running_var.lerp_(var.to(self.running_var.dtype), 0.1)
        return F.batch_norm(x, None, None, self.weight.to(dt),
                            self.bias.to(dt), True, 0.0, self.eps)

    def _world_forward(self, x):
        """Train mode in a `torch.distributed` world: the global batch's
        mean, then its biased variance as the world's mean of (x − mean)²
        (two passes: E[x²] − E[x]² cancels on the stem's [0, 255] inputs),
        both differentiable, as JAX's BatchNorm over a sharded batch."""
        mean = world_mean(x.mean(dim=(0, 2, 3)))
        var = world_mean(((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3)))
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), 0.1)
            self.running_var.lerp_(var.to(self.running_var.dtype), 0.1)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        return (x - mean[:, None, None]) * scale[:, None, None] + \
            self.bias.to(x.dtype)[:, None, None]


def _lrelu(x, slope):
    return torch.where(x >= 0, x, x * slope)


def _hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def _conv(cin, cout, k=3, stride=1, groups=1, bias=False):
    return Conv(cin, cout, k, stride, k // 2, groups=groups, bias=bias)


class ConvBN(nn.Sequential):
    """Sequential(conv, bn), the reference's `conv_bn*`; the activation
    (LeakyReLU with `leaky`, none when `leaky` is None) has no parameters."""

    def __init__(self, cin, cout, k=3, stride=1, leaky=0.0, groups=1):
        super().__init__(_conv(cin, cout, k, stride, groups), BN(cout))
        self.leaky = leaky

    def forward(self, x):
        x = self[1](self[0](x))
        return x if self.leaky is None else _lrelu(x, self.leaky)


class ConvDW(nn.Sequential):
    """Reference `conv_dw`: Sequential(dw conv, bn, lrelu, pw conv, bn,
    lrelu); indices 2 and 5 are the parameter-free activations."""

    def __init__(self, cin, cout, stride, leaky=0.1):
        super().__init__(_conv(cin, cin, 3, stride, groups=cin), BN(cin),
                         nn.Identity(), _conv(cin, cout, 1), BN(cout),
                         nn.Identity())
        self.leaky = leaky

    def forward(self, x):
        x = _lrelu(self[1](self[0](x)), self.leaky)
        return _lrelu(self[4](self[3](x)), self.leaky)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BN(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BN(features)
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(_conv(cin, features, 1, stride),
                                            BN(features))
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = BN(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BN(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = BN(features * 4)
        if stride != 1 or cin != features * 4:
            self.downsample = nn.Sequential(
                _conv(cin, features * 4, 1, stride), BN(features * 4))
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class ResNetBackbone(nn.Module):
    """torchvision-named resnet18/50 trunk returning the layer2/3/4 taps."""

    def __init__(self, depth: int = 18):
        super().__init__()
        block, layers = ((BasicBlock, (2, 2, 2, 2)) if depth == 18
                         else (Bottleneck, (3, 4, 6, 3)))
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BN(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)  # -inf padding, as in JAX
        cin = 64
        for li, (f, n) in enumerate(zip((64, 128, 256, 512), layers), 1):
            blocks = []
            for bi in range(n):
                blocks.append(block(cin, f, 2 if bi == 0 and li > 1 else 1))
                cin = f * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.out_channels = tuple(f * block.expansion for f in (128, 256, 512))

    def forward(self, x):
        h = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        h = self.layer1(h)
        taps = [self.layer2(h)]
        taps.append(self.layer3(taps[-1]))
        taps.append(self.layer4(taps[-1]))
        return taps


class MobileNetV1Backbone(nn.Module):
    """Width-0.25 MobileNetV1 trunk (ref net.py:103-140), LeakyReLU 0.1;
    taps stage1/2/3 at strides 8/16/32 with 64/128/256 channels."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            ConvBN(3, 8, 3, 2, leaky=0.1), ConvDW(8, 16, 1),
            ConvDW(16, 32, 2), ConvDW(32, 32, 1), ConvDW(32, 64, 2),
            ConvDW(64, 64, 1))
        self.stage2 = nn.Sequential(
            ConvDW(64, 128, 2), *[ConvDW(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(ConvDW(128, 256, 2), ConvDW(256, 256, 1))
        self.out_channels = (64, 128, 256)

    def forward(self, x):
        taps = [self.stage1(x)]
        taps.append(self.stage2(taps[-1]))
        taps.append(self.stage3(taps[-1]))
        return taps


class MobileNetV3Backbone(nn.Module):
    """The JAX package's working MobileNetV3 trunk (the reference's is dead
    code): inverted-residual blocks with hard-swish, no squeeze-excite; taps
    of 128/256/512 channels at strides 8/16/32."""

    def __init__(self):
        super().__init__()
        self.stem_conv = _conv(3, 16, 3, 2)
        self.stem_bn = BN(16)
        inp = 16
        for i, (oup, stride, expand) in enumerate(_V3_BLOCKS):
            mid = inp * expand
            setattr(self, f"block{i}_pw1", _conv(inp, mid, 1))
            setattr(self, f"block{i}_bn1", BN(mid))
            setattr(self, f"block{i}_dw", _conv(mid, mid, 3, stride, mid))
            setattr(self, f"block{i}_bn2", BN(mid))
            setattr(self, f"block{i}_pw2", _conv(mid, oup, 1))
            setattr(self, f"block{i}_bn3", BN(oup))
            inp = oup
        self.out_channels = (128, 256, 512)

    def forward(self, x):
        h = _hswish(self.stem_bn(self.stem_conv(x)))
        taps = []
        for i, (_, stride, _) in enumerate(_V3_BLOCKS):
            m = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            r = _hswish(m("bn1")(m("pw1")(h)))
            r = _hswish(m("bn2")(m("dw")(r)))
            r = m("bn3")(m("pw2")(r))
            h = r + h if stride == 1 and r.shape[1] == h.shape[1] else r
            if i in (3, 5, 7):
                taps.append(h)
        return taps


class SSH(nn.Module):
    """3/5/7-receptive-field conv fusion (ref net.py:40-66)."""

    def __init__(self, cin: int, oc: int):
        super().__init__()
        leaky = 0.1 if oc <= 64 else 0.0
        self.conv3X3 = ConvBN(cin, oc // 2, leaky=None)
        self.conv5X5_1 = ConvBN(cin, oc // 4, leaky=leaky)
        self.conv5X5_2 = ConvBN(oc // 4, oc // 4, leaky=None)
        self.conv7X7_2 = ConvBN(oc // 4, oc // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(oc // 4, oc // 4, leaky=None)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7],
                                dim=1))


class FPN(nn.Module):
    """Top-down feature pyramid (ref net.py:68-101)."""

    def __init__(self, in_channels, oc: int):
        super().__init__()
        leaky = 0.1 if oc <= 64 else 0.0
        for i, cin in enumerate(in_channels, 1):
            setattr(self, f"output{i}", ConvBN(cin, oc, 1, leaky=leaky))
        self.merge1 = ConvBN(oc, oc, leaky=leaky)
        self.merge2 = ConvBN(oc, oc, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = (self.output1(feats[0]), self.output2(feats[1]),
                      self.output3(feats[2]))
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[-2:],
                                            mode="nearest-exact"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[-2:],
                                            mode="nearest-exact"))
        return [o1, o2, o3]


class Head(nn.Module):
    """One level's 1×1 head (the reference's ClassHead/BboxHead/
    LandmarkHead module, which names its conv `conv1x1`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = _conv(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv1x1(x)


@ARCH_REGISTRY.register()
class RetinaFace(nn.Module):
    """Backbone → FPN → SSH → per-level 1×1 heads (2 anchors).

    forward: (N, H, W, 3) → loc (N, P, 4), conf (N, P, 2) (softmax unless
    phase == "train"), landm (N, P, 10), priors in (h, w, anchor) order.
    `dtype` casts the input, and with it every layer.
    """

    def __init__(self, backbone: str = "Resnet18", out_channel: int = 256,
                 phase: str = "train", dtype=None):
        super().__init__()
        if backbone == "mobilenet0.25":
            self.body = MobileNetV1Backbone()
        elif backbone == "MobilenetV3":
            self.body = MobileNetV3Backbone()
        else:
            self.body = ResNetBackbone(18 if "18" in backbone else 50)
        self.phase, self.dtype = phase, dtype
        self.fpn = FPN(self.body.out_channels, out_channel)
        for i in range(1, 4):
            setattr(self, f"ssh{i}", SSH(out_channel, out_channel))
        self.ClassHead = nn.ModuleList(Head(out_channel, 4) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(out_channel, 8) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(out_channel, 20)
                                          for _ in range(3))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = self.fpn(self.body(x.permute(0, 3, 1, 2)))
        feats = [self.ssh1(feats[0]), self.ssh2(feats[1]),
                 self.ssh3(feats[2])]
        n = x.shape[0]

        def head(heads, k):
            return torch.cat([h(f).permute(0, 2, 3, 1).reshape(n, -1, k)
                              for h, f in zip(heads, feats)], dim=1)

        loc = head(self.BboxHead, 4)
        conf = head(self.ClassHead, 2)
        if self.phase != "train":
            conf = torch.softmax(conf, dim=-1)
        return loc, conf, head(self.LandmarkHead, 10)
