"""DFDNet, blind face restoration through deep multi-scale component
dictionaries.

Port of `image_restoration_tpu/archs/dfdnet_arch.py:36-268`: a VGG19 face
encoder (the port's `VGGFeatureExtractor`, `range_norm`, tapped at
relu2_2/relu3_4/relu4_4/conv5_4), a per-part dictionary swap at each tap
(the ROI resized to the atoms' size, the atoms AdaIN-matched to it with
the unbiased variance, the best atom by inner product resized back with
torch's `nearest`, blended through an attention block), a multi-scale
dilation bottleneck (dilations 4/3/2/1) and an SFT decoder (blur, conv,
LeakyReLU 0.04, the SFT scale and sigmoid shift from the swapped feature,
bilinear ×2, conv) ending in `upsample4` (conv, two residual blocks, conv,
tanh). NHWC at the forward; batch 1 only, as in the reference.

Each part reads the unmodified VGG feature and writes into a clone of it,
so overlapping boxes never see an earlier part's write. A box becomes
`loc // (512 / f_size)` in integers at each tap. The swap runs eagerly on
host-side boxes, as JAX's does.

The convs keep flax's default init, as JAX's plain `nn.Conv`s have it.
Parameters keep the reference checkpoint's names (`attn_blocks.left_eye_256.
{0,2}`, `multi_scale_dilation.conv_blocks.i.{0,2}`, `upsampleN.conv1.1`,
`scale_block.{0,2}`, `shift_block.{0,2}`, `convup.1`, `upsample4.{0,2,3,4}`)
but for the VGG's (`vgg_extractor.features.N`); `convert/dfdnet_import.py`
folds a reference checkpoint's spectral norm, maps its VGG names and drops
its mean/std buffers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import const_tensor
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv
from .vgg_arch import VGGFeatureExtractor

PARTS = ("left_eye", "right_eye", "nose", "mouth")
VGG_LAYERS = ("relu2_2", "relu3_4", "relu4_4", "conv5_4")
FEATURE_SIZES = (256, 128, 64, 32)
CHANNEL_SIZES = (128, 256, 512, 512)

_BINOMIAL = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(cin, cout, dilation=1):
    return Conv(cin, cout, 3, dilation=dilation, init="flax")


def blur3(x):
    """Depthwise 3×3 binomial blur of NHWC, zero padding (dfdnet_util.py
    Blur)."""
    c = x.shape[-1]
    k = const_tensor(_BINOMIAL, x.dtype, x.device) / 16.0
    y = F.conv2d(_nchw(x), k.expand(c, 1, 3, 3), padding=1, groups=c)
    return _nhwc(y)


def bilinear(x, size):
    """torch's bilinear, align_corners=False, no antialias, over NHWC."""
    return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode="bilinear",
                               align_corners=False))


def nearest(x, size):
    """torch's `nearest` over NHWC: src = floor(dst·in/out)."""
    return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode="nearest"))


def adaptive_instance_normalization(content, style, eps=1e-5):
    """AdaIN over NHWC: content matched to style's per-channel mean and
    std, both with the unbiased variance (torch.var's default)."""
    c_mean = content.mean(dim=(-3, -2), keepdim=True)
    c_std = torch.sqrt(content.var(dim=(-3, -2), keepdim=True) + eps)
    s_mean = style.mean(dim=(-3, -2), keepdim=True)
    s_std = torch.sqrt(style.var(dim=(-3, -2), keepdim=True) + eps)
    return (content - c_mean) / c_std * s_std + s_mean


class Blur(nn.Module):
    def forward(self, x):
        return blur3(x)


class Bilinear2x(nn.Module):
    def forward(self, x):
        return bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))


def attention_block(c: int) -> nn.Sequential:
    """conv → LeakyReLU(0.2) → conv."""
    return nn.Sequential(_conv(c, c), nn.LeakyReLU(0.2), _conv(c, c))


class MSDilationBlock(nn.Module):
    """Four dilated conv pairs in parallel, fused by a conv, plus the
    input."""

    def __init__(self, channels: int, dilation: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        self.conv_blocks = nn.ModuleList([
            nn.Sequential(_conv(channels, channels, d), nn.LeakyReLU(0.2),
                          _conv(channels, channels, d))
            for d in dilation])
        self.conv_fusion = _conv(4 * channels, channels)

    def forward(self, x):
        h = torch.cat([blk(x) for blk in self.conv_blocks], dim=-1)
        return self.conv_fusion(h) + x


class UpResBlock(nn.Module):
    """x + conv(LeakyReLU(0.2)(conv(x)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = nn.Sequential(_conv(channels, channels),
                                  nn.LeakyReLU(0.2),
                                  _conv(channels, channels))

    def forward(self, x):
        return x + self.body(x)


class SFTUpBlock(nn.Module):
    """conv1 (blur, conv, LeakyReLU 0.04: the reference's two 0.2
    activations), then ·scale + sigmoid(shift) from the swapped feature,
    then convup (bilinear ×2, conv, LeakyReLU 0.2)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = nn.Sequential(Blur(), _conv(in_channel, out_channel),
                                   nn.LeakyReLU(0.04))
        self.convup = nn.Sequential(Bilinear2x(),
                                    _conv(out_channel, out_channel),
                                    nn.LeakyReLU(0.2))
        self.scale_block = nn.Sequential(
            _conv(in_channel, out_channel), nn.LeakyReLU(0.2),
            _conv(out_channel, out_channel))
        self.shift_block = nn.Sequential(
            _conv(in_channel, out_channel), nn.LeakyReLU(0.2),
            _conv(out_channel, out_channel), nn.Sigmoid())

    def forward(self, x, updated_feat):
        out = self.conv1(x) * self.scale_block(updated_feat) \
            + self.shift_block(updated_feat)
        return self.convup(out)


def part_box(loc, f_size: int) -> np.ndarray:
    """A part's (x1, y1, x2, y2) in input pixels → integer coordinates at
    the tap of `f_size`: loc // (512 / f_size)."""
    if torch.is_tensor(loc):
        loc = loc.detach().cpu().numpy()
    loc = np.asarray(loc).reshape(-1)[:4]
    return (loc // (512 / f_size)).astype(np.int64)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    """forward(x, part_locations, dictionaries):

    x: (1, H, W, 3) RGB in [-1, 1] (512² in the reference);
    part_locations: four (x1, y1, x2, y2) boxes in input pixels, ordered
      left_eye, right_eye, nose, mouth (arrays or tensors);
    dictionaries: {"256"|"128"|"64"|"32": {part: (K, h, w, C)}} NHWC tensors
      on the net's device (`convert.dfdnet_import.load_dfdnet_dict`).
    Returns (1, H, W, 3) in [-1, 1].
    """

    def __init__(self, num_feat: int = 64):
        super().__init__()
        nf = num_feat
        self.vgg_extractor = VGGFeatureExtractor(
            layer_name_list=VGG_LAYERS, vgg_type="vgg19",
            use_input_norm=True, range_norm=True)
        self.attn_blocks = nn.ModuleDict({
            f"{part}_{f_size}": attention_block(c)
            for f_size, c in zip(FEATURE_SIZES, CHANNEL_SIZES)
            for part in PARTS})
        self.multi_scale_dilation = MSDilationBlock(nf * 8, (4, 3, 2, 1))
        self.upsample0 = SFTUpBlock(nf * 8, nf * 8)
        self.upsample1 = SFTUpBlock(nf * 8, nf * 4)
        self.upsample2 = SFTUpBlock(nf * 4, nf * 2)
        self.upsample3 = SFTUpBlock(nf * 2, nf)
        self.upsample4 = nn.Sequential(
            _conv(nf, nf), nn.LeakyReLU(0.2), UpResBlock(nf), UpResBlock(nf),
            _conv(nf, 3), nn.Tanh())

    def swap(self, vgg_feat, updated, dict_feat, box, part, f_size):
        """Swap one part's ROI at one tap: reads `vgg_feat`, writes the
        blend into `updated` (in place)."""
        x1, y1, x2, y2 = (int(v) for v in box)
        part_feat = vgg_feat[:, y1:y2, x1:x2, :]
        part_resized = bilinear(part_feat, dict_feat.shape[1:3])
        atoms = adaptive_instance_normalization(dict_feat, part_resized)
        # the inner product of the ROI with every atom (the reference's
        # F.conv2d with the atoms as filters of exactly the ROI's size)
        scores = torch.einsum("hwc,khwc->k", part_resized[0], atoms)
        atom = atoms.index_select(0, torch.argmax(scores).reshape(1))
        swap_feat = nearest(atom, part_feat.shape[1:3])
        attn = self.attn_blocks[f"{part}_{f_size}"](swap_feat - part_feat)
        updated[:, y1:y2, x1:x2, :] = attn * swap_feat + part_feat

    def forward(self, x, part_locations, dictionaries: Dict):
        if x.shape[0] != 1:
            raise ValueError(f"DFDNet runs batch 1 only, as the reference; "
                             f"got {x.shape[0]}")
        feats = self.vgg_extractor(x)
        updated_feats = []
        for layer, f_size in zip(VGG_LAYERS, FEATURE_SIZES):
            vgg_feat = feats[layer]
            updated = vgg_feat.clone()
            for i, part in enumerate(PARTS):
                self.swap(vgg_feat, updated, dictionaries[str(f_size)][part],
                          part_box(part_locations[i], f_size), part, f_size)
            updated_feats.append(updated)
        h = self.multi_scale_dilation(feats["conv5_4"])
        h = self.upsample0(h, updated_feats[3])
        h = self.upsample1(h, updated_feats[2])
        h = self.upsample2(h, updated_feats[1])
        h = self.upsample3(h, updated_feats[0])
        return self.upsample4(h)
