"""EDVR: video restoration with PCD alignment and TSA fusion.

Port of `image_restoration_tpu/archs/edvr_arch.py`: `DCNv2Pack` (:33, the
modulated deformable conv whose offsets and mask come from a conv of a
feature), `PCDAlignment` (:67, three pyramid levels and the cascading DCN
at L1), `TSAFusion` (:122, temporal and spatial attention),
`PredeblurModule` (:182) and `EDVR` (:220: `hr_in`, `with_predeblur`,
`with_tsa`, `center_frame_idx`). Input (N, T, H, W, 3), output the centre
frame ×4 (or at the input's size with `hr_in`), NHWC.

Parameters keep the reference's keys: the per-level ModuleDicts
(`pcd_align.offset_conv1.l3`, `pcd_align.dcn_pack.l2`, …), the DCN's
`weight`/`bias`/`conv_offset`, `feature_extraction.i`,
`reconstruction.i`, `predeblur.resblock_l1.i`, so a BasicSR `.pth` loads
strictly. `dcn_max_offset=R` clamps the DCN offsets to ±R (JAX's windowed
DCN's meaning).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import modulated_deform_conv
from ..ops.pixel_ops import pixel_shuffle
from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, ResidualBlockNoBN


def lrelu(x):
    return F.leaky_relu(x, 0.1)


class DCNv2Pack(nn.Module):
    """3×3 modulated deform conv of x, its offsets and mask from
    `conv_offset(feat)`: cat(o1, o2) goes to the op as it is (the group
    view crosses the o1/o2 boundary), the mask through a sigmoid."""

    def __init__(self, cin: int, cout: int, deformable_groups: int = 8,
                 max_offset: Optional[int] = None):
        super().__init__()
        self.deformable_groups, self.max_offset = deformable_groups, max_offset
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset = Conv(cin, deformable_groups * 3 * 9, 3)

    def reset_parameters(self, generator=None):
        if generator is None:
            return
        with torch.no_grad():  # JAX: variance_scaling(2, fan_in), zero bias
            fan_in = self.weight[0].numel()
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x, feat):
        out = self.conv_offset(feat)
        o1, o2, mask = torch.chunk(out, 3, dim=-1)
        return modulated_deform_conv(
            x, torch.cat([o1, o2], dim=-1), torch.sigmoid(mask), self.weight,
            self.bias, stride=1, padding=1,
            deformable_groups=self.deformable_groups,
            max_offset=self.max_offset)


class PCDAlignment(nn.Module):
    """Pyramid, cascading and deformable alignment of a neighbour's
    [L1, L2, L3] features to the reference frame's."""

    def __init__(self, num_feat: int = 64, deformable_groups: int = 8,
                 dcn_max_offset: Optional[int] = None):
        super().__init__()
        f = num_feat
        self.offset_conv1, self.offset_conv2 = nn.ModuleDict(), nn.ModuleDict()
        self.offset_conv3, self.dcn_pack = nn.ModuleDict(), nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            level = f"l{i}"
            self.offset_conv1[level] = Conv(2 * f, f)
            if i == 3:
                self.offset_conv2[level] = Conv(f, f)
            else:
                self.offset_conv2[level] = Conv(2 * f, f)
                self.offset_conv3[level] = Conv(f, f)
            self.dcn_pack[level] = DCNv2Pack(f, f, deformable_groups,
                                             dcn_max_offset)
            if i < 3:
                self.feat_conv[level] = Conv(2 * f, f)
        self.cas_offset_conv1 = Conv(2 * f, f)
        self.cas_offset_conv2 = Conv(f, f)
        self.cas_dcnpack = DCNv2Pack(f, f, deformable_groups, dcn_max_offset)

    def forward(self, nbr_feat_l, ref_feat_l):
        up_offset = up_feat = feat = None
        for i in range(3, 0, -1):
            level = f"l{i}"
            offset = lrelu(self.offset_conv1[level](
                torch.cat([nbr_feat_l[i - 1], ref_feat_l[i - 1]], dim=-1)))
            if i == 3:
                offset = lrelu(self.offset_conv2[level](offset))
            else:
                offset = lrelu(self.offset_conv2[level](
                    torch.cat([offset, up_offset], dim=-1)))
                offset = lrelu(self.offset_conv3[level](offset))
            feat = self.dcn_pack[level](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[level](torch.cat([feat, up_feat],
                                                       dim=-1))
            if i > 1:
                feat = lrelu(feat)
                hw = (offset.shape[1] * 2, offset.shape[2] * 2)
                up_offset = resize(offset, hw, "bilinear") * 2
                up_feat = resize(feat, hw, "bilinear")
        offset = lrelu(self.cas_offset_conv1(
            torch.cat([feat, ref_feat_l[0]], dim=-1)))
        offset = lrelu(self.cas_offset_conv2(offset))
        return lrelu(self.cas_dcnpack(feat, offset))


def _pool(x, kind):
    """3×3 stride-2 pad-1 max or average pool (padding counted) of NHWC."""
    pool = F.max_pool2d if kind == "max" else F.avg_pool2d
    return pool(x.permute(0, 3, 1, 2), 3, stride=2,
                padding=1).permute(0, 2, 3, 1)


class TSAFusion(nn.Module):
    """Temporal and spatial attention: aligned (N, T, H, W, F) → (N, H, W,
    F)."""

    def __init__(self, num_feat: int = 64, num_frame: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        f = num_feat
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = Conv(f, f)
        self.temporal_attn2 = Conv(f, f)
        self.feat_fusion = Conv(num_frame * f, f, 1)
        self.spatial_attn1 = Conv(num_frame * f, f, 1)
        self.spatial_attn2 = Conv(2 * f, f, 1)
        self.spatial_attn3 = Conv(f, f)
        self.spatial_attn4 = Conv(f, f, 1)
        self.spatial_attn5 = Conv(f, f)
        self.spatial_attn_l1 = Conv(f, f, 1)
        self.spatial_attn_l2 = Conv(2 * f, f)
        self.spatial_attn_l3 = Conv(f, f)
        self.spatial_attn_add1 = Conv(f, f, 1)
        self.spatial_attn_add2 = Conv(f, f, 1)

    def forward(self, aligned):
        n, t, h, w, f = aligned.shape
        emb_ref = self.temporal_attn1(aligned[:, self.center_frame_idx])
        emb = self.temporal_attn2(aligned.reshape(-1, h, w, f)).reshape(
            n, t, h, w, f)
        corr_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(
            -1, keepdim=True))
        weighted = (aligned * corr_prob).permute(0, 2, 3, 1, 4).reshape(
            n, h, w, t * f)
        feat = lrelu(self.feat_fusion(weighted))

        attn = lrelu(self.spatial_attn1(weighted))
        attn = lrelu(self.spatial_attn2(torch.cat(
            [_pool(attn, "max"), _pool(attn, "avg")], dim=-1)))
        level = lrelu(self.spatial_attn_l1(attn))
        level = lrelu(self.spatial_attn_l2(torch.cat(
            [_pool(level, "max"), _pool(level, "avg")], dim=-1)))
        level = lrelu(self.spatial_attn_l3(level))
        level = resize(level, attn.shape[1:3], "bilinear")
        attn = lrelu(self.spatial_attn3(attn)) + level
        attn = lrelu(self.spatial_attn4(attn))
        attn = self.spatial_attn5(resize(attn, (h, w), "bilinear"))
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class PredeblurModule(nn.Module):
    """The pre-deblur head: strided convs to L2/L3, residual blocks, and
    the coarser levels added back bilinearly."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 hr_in: bool = False):
        super().__init__()
        f = num_feat
        self.hr_in = hr_in
        self.conv_first = Conv(num_in_ch, f)
        if hr_in:
            self.stride_conv_hr1 = Conv(f, f, stride=2)
            self.stride_conv_hr2 = Conv(f, f, stride=2)
        self.stride_conv_l2 = Conv(f, f, stride=2)
        self.stride_conv_l3 = Conv(f, f, stride=2)
        self.resblock_l3 = ResidualBlockNoBN(f)
        self.resblock_l2_1 = ResidualBlockNoBN(f)
        self.resblock_l2_2 = ResidualBlockNoBN(f)
        self.resblock_l1 = nn.ModuleList(ResidualBlockNoBN(f)
                                         for _ in range(5))

    def forward(self, x):
        l1 = lrelu(self.conv_first(x))
        if self.hr_in:
            l1 = lrelu(self.stride_conv_hr2(lrelu(self.stride_conv_hr1(l1))))
        l2 = lrelu(self.stride_conv_l2(l1))
        l3 = lrelu(self.stride_conv_l3(l2))
        l3 = resize(self.resblock_l3(l3), l2.shape[1:3], "bilinear")
        l2 = self.resblock_l2_2(self.resblock_l2_1(l2) + l3)
        l2 = resize(l2, l1.shape[1:3], "bilinear")
        for i in range(2):
            l1 = self.resblock_l1[i](l1)
        l1 = l1 + l2
        for i in range(2, 5):
            l1 = self.resblock_l1[i](l1)
        return l1


def pyramid(net, x):
    """(L1, L2, L3) features of (N·T, H, W, F) frames through the
    conv_l2_* and conv_l3_* convs of `net`."""
    l2 = lrelu(net.conv_l2_2(lrelu(net.conv_l2_1(x))))
    l3 = lrelu(net.conv_l3_2(lrelu(net.conv_l3_1(l2))))
    return x, l2, l3


def align(pcd, feats, n, t, center):
    """Each of the T frames' pyramid aligned to the centre's: (N, T, H, W,
    F)."""
    levels = [f.reshape((n, t) + f.shape[1:]) for f in feats]
    ref = [lv[:, center] for lv in levels]
    return torch.stack([pcd([lv[:, i] for lv in levels], ref)
                        for i in range(t)], dim=1)


def add_pyramid_convs(net, f: int) -> None:
    net.conv_l2_1 = Conv(f, f, stride=2)
    net.conv_l2_2 = Conv(f, f)
    net.conv_l3_1 = Conv(f, f, stride=2)
    net.conv_l3_2 = Conv(f, f)


@ARCH_REGISTRY.register()
class EDVR(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_frame: int = 5,
                 deformable_groups: int = 8, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10,
                 center_frame_idx: Optional[int] = None, hr_in: bool = False,
                 with_predeblur: bool = False, with_tsa: bool = True,
                 dcn_max_offset: Optional[int] = None):
        super().__init__()
        f = num_feat
        self.center_frame_idx = (num_frame // 2 if center_frame_idx is None
                                 else center_frame_idx)
        self.hr_in, self.with_predeblur = hr_in, with_predeblur
        self.with_tsa = with_tsa
        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch, f, hr_in)
            self.conv_1x1 = Conv(f, f, 1)
        else:
            self.conv_first = Conv(num_in_ch, f)
        self.feature_extraction = nn.Sequential(
            *[ResidualBlockNoBN(f) for _ in range(num_extract_block)])
        add_pyramid_convs(self, f)
        self.pcd_align = PCDAlignment(f, deformable_groups, dcn_max_offset)
        if with_tsa:
            self.fusion = TSAFusion(f, num_frame, self.center_frame_idx)
        else:
            self.fusion = Conv(num_frame * f, f, 1)
        self.reconstruction = nn.Sequential(
            *[ResidualBlockNoBN(f) for _ in range(num_reconstruct_block)])
        self.upconv1 = Conv(f, f * 4)
        self.upconv2 = Conv(f, 64 * 4)
        self.conv_hr = Conv(64, 64)
        self.conv_last = Conv(64, num_out_ch)

    def forward(self, x):
        n, t, h, w, c = x.shape
        x_center = x[:, self.center_frame_idx]
        flat = x.reshape(-1, h, w, c)
        if self.with_predeblur:
            l1 = self.conv_1x1(self.predeblur(flat))
            if self.hr_in:
                h, w = h // 4, w // 4
        else:
            l1 = lrelu(self.conv_first(flat))
        feats = pyramid(self, self.feature_extraction(l1))
        aligned = align(self.pcd_align, feats, n, t, self.center_frame_idx)
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.permute(0, 2, 3, 1, 4).reshape(
                n, h, w, -1))
        out = self.reconstruction(feat)
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        base = x_center if self.hr_in else resize(x_center, (4 * h, 4 * w),
                                                  "bilinear")
        return out + base
