"""BasicVSR and IconVSR: bidirectional recurrent video SR.

Port of `image_restoration_tpu/archs/basicvsr_arch.py`:
`ConvResidualBlocks` (:34), `BasicVSR` (:51, `get_flow` :81),
`EDVRFeatureExtractor` (:146, EDVR's pyramid, PCD with 8 deformable
groups and TSA, for the keyframes) and `IconVSR` (:192, keyframe refill,
temporal padding, the input reflect-padded to a multiple of 4). JAX runs
the recurrences as `nn.scan`; here they are Python loops over T, the same
computation (`tests/test_video_archs.py:229`). Input (N, T, H, W, 3),
output (N, T, 4H, 4W, 3), NHWC.

Parameters keep the reference's keys (`backward_trunk.main.0`,
`backward_trunk.main.2.i`, `spynet.basic_module.N.basic_module.M`,
`edvr.pcd_align…`), so a BasicSR `.pth` loads strictly. `spynet_path` and
`edvr_path` load the reference's SpyNet and EDVR `.pth` after
`build_network` draws the weights; a path that is given but missing
raises. `flow_max_offset` / `dcn_max_offset` clamp the warps' flows and
the DCN's offsets (JAX's windowed paths' meaning).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.pixel_ops import pixel_shuffle
from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Conv, ResidualBlockNoBN, flow_warp
from .edvr_arch import (PCDAlignment, TSAFusion, add_pyramid_convs, align,
                        lrelu, pyramid)
from .spynet_arch import SpyNet, load_pretrained_path


class ConvResidualBlocks(nn.Module):
    """conv + LeakyReLU(0.1) + `num_block` residual blocks, under the
    reference's `main` Sequential."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 64,
                 num_block: int = 15):
        super().__init__()
        self.main = nn.Sequential(
            Conv(num_in_ch, num_out_ch), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(num_out_ch)
                            for _ in range(num_block)]))

    def forward(self, x):
        return self.main(x)


class _Upsampler(nn.Module):
    """The reconstruction shared by both nets: ×2, ×2 pixel shuffles, a
    conv and the last conv, plus the bilinear ×4 of the input frame."""

    def _init_upsampler(self, num_feat: int):
        self.upconv1 = Conv(num_feat, num_feat * 4)
        self.upconv2 = Conv(num_feat, 64 * 4)
        self.conv_hr = Conv(64, 64)
        self.conv_last = Conv(64, 3)

    def upsample(self, feat, x_i):
        out = lrelu(pixel_shuffle(self.upconv1(feat), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        h, w = x_i.shape[1:3]
        return out + resize(x_i, (4 * h, 4 * w), "bilinear")


def get_flows(spynet, x):
    """(forward, backward) flows between neighbours, each (N, T−1, H, W,
    2): backward i warps frame i+1 to frame i."""
    n, t, h, w, c = x.shape
    x1 = x[:, :-1].reshape(-1, h, w, c)
    x2 = x[:, 1:].reshape(-1, h, w, c)
    flows_backward = spynet(x1, x2).reshape(n, t - 1, h, w, 2)
    flows_forward = spynet(x2, x1).reshape(n, t - 1, h, w, 2)
    return flows_forward, flows_backward


@ARCH_REGISTRY.register()
class BasicVSR(_Upsampler):
    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 spynet_path: Optional[str] = None,
                 flow_max_offset: Optional[int] = None):
        super().__init__()
        self.num_feat, self.flow_max_offset = num_feat, flow_max_offset
        self.spynet = SpyNet(spynet_path)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                num_block)
        self.fusion = Conv(num_feat * 2, num_feat, 1)
        self._init_upsampler(num_feat)

    def get_flow(self, x):
        return get_flows(self.spynet, x)

    def forward(self, x):
        n, t, h, w, _ = x.shape
        flows_forward, flows_backward = self.get_flow(x)
        feat_prop = x.new_zeros(n, h, w, self.num_feat)
        backward = [None] * t
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i],
                                      max_flow=self.flow_max_offset)
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      dim=-1))
            backward[i] = feat_prop
        out = []
        feat_prop = torch.zeros_like(feat_prop)
        for i in range(t):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1],
                                      max_flow=self.flow_max_offset)
            feat_prop = self.forward_trunk(torch.cat([x[:, i], feat_prop],
                                                     dim=-1))
            fused = lrelu(self.fusion(torch.cat([backward[i], feat_prop],
                                                dim=-1)))
            out.append(self.upsample(fused, x[:, i]))
        return torch.stack(out, dim=1)


@ARCH_REGISTRY.register()
class EDVRFeatureExtractor(nn.Module):
    """EDVR's trunk for a window of frames: the fused centre feature (N, H,
    W, F)."""

    def __init__(self, num_input_frame: int = 5, num_feat: int = 64,
                 load_path: Optional[str] = None,
                 dcn_max_offset: Optional[int] = None):
        super().__init__()
        self.load_path = load_path
        self.center_frame_idx = num_input_frame // 2
        self.conv_first = Conv(3, num_feat)
        self.feature_extraction = nn.Sequential(
            *[ResidualBlockNoBN(num_feat) for _ in range(5)])
        add_pyramid_convs(self, num_feat)
        self.pcd_align = PCDAlignment(num_feat, 8, dcn_max_offset)
        self.fusion = TSAFusion(num_feat, num_input_frame,
                                self.center_frame_idx)

    def load_pretrained(self):
        load_pretrained_path(self, self.load_path)

    def forward(self, x):
        n, t, h, w, c = x.shape
        feat = self.feature_extraction(lrelu(self.conv_first(
            x.reshape(-1, h, w, c))))
        return self.fusion(align(self.pcd_align, pyramid(self, feat), n, t,
                                 self.center_frame_idx))


@ARCH_REGISTRY.register()
class IconVSR(_Upsampler):
    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 keyframe_stride: int = 5, temporal_padding: int = 2,
                 spynet_path: Optional[str] = None,
                 edvr_path: Optional[str] = None,
                 dcn_max_offset: Optional[int] = None,
                 flow_max_offset: Optional[int] = None):
        super().__init__()
        self.num_feat, self.flow_max_offset = num_feat, flow_max_offset
        self.keyframe_stride = keyframe_stride
        self.temporal_padding = temporal_padding
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat,
                                         edvr_path, dcn_max_offset)
        self.spynet = SpyNet(spynet_path)
        self.backward_fusion = Conv(2 * num_feat, num_feat)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_fusion = Conv(2 * num_feat, num_feat)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat,
                                                num_block)
        self._init_upsampler(num_feat)

    def keyframe_features(self, x, keyframe_idx):
        """{i: EDVR's feature of the window centred on keyframe i}, the
        clip mirrored by `temporal_padding` frames at each end."""
        tp = self.temporal_padding
        x_pad = torch.cat([x[:, 1:1 + tp].flip(1), x,
                           x[:, -tp - 1:-1].flip(1)], dim=1)
        return {i: self.edvr(x_pad[:, i:i + 2 * tp + 1])
                for i in keyframe_idx}

    def forward(self, x):
        n, t, h, w, _ = x.shape
        ph, pw = (4 - h % 4) % 4, (4 - w % 4) % 4
        if ph or pw:
            x = torch.nn.functional.pad(
                x.reshape(n * t, h, w, 3).permute(0, 3, 1, 2),
                (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1).reshape(
                n, t, h + ph, w + pw, 3)
        hh, ww = h + ph, w + pw
        keyframe_idx = list(range(0, t, self.keyframe_stride))
        if keyframe_idx[-1] != t - 1:
            keyframe_idx.append(t - 1)
        flows_forward, flows_backward = get_flows(self.spynet, x)
        feats_key = self.keyframe_features(x, keyframe_idx)

        backward = [None] * t
        feat_prop = x.new_zeros(n, hh, ww, self.num_feat)
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i],
                                      max_flow=self.flow_max_offset)
            if i in feats_key:
                feat_prop = self.backward_fusion(torch.cat(
                    [feat_prop, feats_key[i]], dim=-1))
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop],
                                                      dim=-1))
            backward[i] = feat_prop
        out = []
        feat_prop = torch.zeros_like(feat_prop)
        for i in range(t):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1],
                                      max_flow=self.flow_max_offset)
            if i in feats_key:
                feat_prop = self.forward_fusion(torch.cat(
                    [feat_prop, feats_key[i]], dim=-1))
            feat_prop = self.forward_trunk(torch.cat(
                [x[:, i], backward[i], feat_prop], dim=-1))
            out.append(self.upsample(feat_prop, x[:, i]))
        return torch.stack(out, dim=1)[:, :, :4 * h, :4 * w]
