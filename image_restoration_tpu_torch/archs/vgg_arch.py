"""VGG feature extractor for the perceptual loss.

Port of `image_restoration_tpu/archs/vgg_arch.py:53`: the VGG conv stack
truncated at the deepest requested tap, ImageNet mean/std input
normalization and optional (−1, 1) → (0, 1) `range_norm`. The layers sit in
`features`, a Sequential with torchvision's indices (conv, relu, ..., pool),
so a torchvision vgg19 state_dict loads with `load_state_dict`. NHWC in,
a dict of NHWC taps out.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.registry import ARCH_REGISTRY

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
_CFGS = {"vgg19": VGG19_CFG, "vgg16": VGG16_CFG}
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def vgg_layer_names(vgg_type: str = "vgg19"):
    """Layer names in torchvision's `features` order (index = position)."""
    names = []
    block, conv = 1, 0
    for v in _CFGS[vgg_type]:
        if v == "M":
            names.append(f"pool{block}")
            block += 1
            conv = 0
        else:
            conv += 1
            names.append(f"conv{block}_{conv}")
            names.append(f"relu{block}_{conv}")
    return names


class _Conv3x3(nn.Conv2d):
    """A VGG conv with flax's init: lecun normal (truncated at 2σ), zero
    bias. Left uninitialized until `reset_parameters(generator)` (which
    `build_network` and `PerceptualLoss` call)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)

    def reset_parameters(self, generator=None):
        if generator is None:  # nn.Conv2d.__init__'s own call
            return
        with torch.no_grad():
            std = math.sqrt(1.0 / self.weight[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Run VGG and return the features at `layer_name_list` taps."""

    def __init__(self, layer_name_list: Sequence[str] = ("conv5_4",),
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, dtype=None):
        super().__init__()
        self.layer_name_list = tuple(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.dtype = dtype
        self.names = vgg_layer_names(vgg_type)
        last = max(self.names.index(n) for n in self.layer_name_list)
        layers, in_ch = [], 3
        for v in _CFGS[vgg_type]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [_Conv3x3(in_ch, v), nn.ReLU(inplace=False)]
                in_ch = v
        self.features = nn.Sequential(*layers[:last + 1])
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)

    def load_torchvision(self, path: str) -> None:
        """Load the `features.N` entries of a torchvision VGG state_dict
        (the classifier's are ignored); every layer held here must be in
        it."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        own = self.state_dict()
        missing = sorted(set(own) - set(sd))
        if missing:
            raise KeyError(f"{path} lacks {missing[:6]}")
        self.load_state_dict({k: sd[k] for k in own}, strict=True)

    def forward(self, x):
        """x: NHWC RGB in [0, 1] (or (−1, 1) with range_norm)."""
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        h = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            h = h.to(self.dtype)
        wanted = set(self.layer_name_list)
        out = {}
        for name, layer in zip(self.names, self.features):
            if isinstance(layer, nn.Conv2d):
                h = F.conv2d(h, layer.weight.to(h.dtype),
                             layer.bias.to(h.dtype), padding=1)
            else:
                h = layer(h)
            if name in wanted:
                out[name] = h.permute(0, 2, 3, 1)
        return out
