"""GFPGANv1OCR — the production license-plate restoration generator.

Port of `image_restoration_tpu/archs/gfpgan_ocr_arch.py:34-246`: UNet encoder
→ style code → SFT condition branches → StyleGAN2 decoder, plus the per-scale
toRGB pyramid. NHWC at every forward; reference parameter names and layouts.

`final_linear` keeps the reference's input-feature order (C, H, W): the
feature map is flattened in that order here, where the JAX module flattens
NHWC and its importer permutes the weight instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from ..ops.fused_act import FusedLeakyReLU, ScaledLeakyReLU
from ..ops.modulated_conv import conv2d
from ..ops.resize import resize
from .stylegan2_arch import (ConvLayer, EqualConv2d, EqualLinear, ResBlock,
                             StyleGAN2OCRGenerator, _cast)


class ConvUpLayer(nn.Module):
    """Bilinear ×2 upsample + equalized conv (+ fused/scaled lrelu)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 bias_init_val: float = 0.0, activate: bool = True,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels))
                     if bias and not activate else None)
        self.activation = None
        if activate:
            self.activation = (FusedLeakyReLU(out_channels) if bias
                               else ScaledLeakyReLU(0.2))
        self.stride, self.padding = stride, padding
        self.bias_init_val = bias_init_val
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init_val)

    def forward(self, x):
        x = _cast(x, self.dtype)
        _, h, w, _ = x.shape
        out = resize(x, (2 * h, 2 * w), "bilinear")
        out = conv2d(out, self.weight * self.scale, stride=self.stride,
                     padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if self.activation is not None:
            out = self.activation(out)
        return out


class ResUpBlock(nn.Module):
    """Residual block with ×2 upsampling."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, bias=True,
                               activate=True, dtype=dtype)
        self.conv2 = ConvUpLayer(in_channels, out_channels, 3, stride=1,
                                 padding=1, bias=True, activate=True,
                                 dtype=dtype)
        self.skip = ConvUpLayer(in_channels, out_channels, 1, bias=False,
                                activate=False, dtype=dtype)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


def sft_condition(in_channels: int, out_channels: int,
                  final_bias_init: float = 0.0, dtype=None) -> nn.Sequential:
    """EqualConv2d → ScaledLeakyReLU → EqualConv2d condition branch (a
    Sequential, so its keys are `0.*` and `2.*` as in the reference)."""
    return nn.Sequential(
        EqualConv2d(in_channels, in_channels, 3, stride=1, padding=1,
                    bias=True, bias_init_val=0.0, dtype=dtype),
        ScaledLeakyReLU(0.2),
        EqualConv2d(in_channels, out_channels, 3, stride=1, padding=1,
                    bias=True, bias_init_val=final_bias_init, dtype=dtype))


@ARCH_REGISTRY.register()
class GFPGANv1OCR(nn.Module):
    """UNet + StyleGAN2 decoder with SFT.

    forward returns (image in (−1,1), out_rgbs pyramid list), NHWC.
    """

    def __init__(self, input_width: int = 768, input_height: int = 32,
                 num_style_feat: int = 512, channel_multiplier: float = 1,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 decoder_load_path: Optional[str] = None,
                 fix_decoder: bool = True, num_mlp: int = 8,
                 lr_mlp: float = 0.01, input_is_latent: bool = False,
                 different_w: bool = False, narrow: float = 1.0,
                 sft_half: bool = False, dtype=None):
        super().__init__()
        self.input_width, self.input_height = input_width, input_height
        self.num_style_feat = num_style_feat
        self.input_is_latent = input_is_latent
        self.different_w = different_w
        self.narrow = narrow
        self.log_size = int(math.log2(min(input_width, input_height)))
        self.ratio = int(input_width / input_height)
        unet_narrow = narrow * 0.5
        channels = {
            4: int(512 * unet_narrow), 8: int(512 * unet_narrow),
            16: int(512 * unet_narrow), 32: int(512 * unet_narrow),
            64: int(256 * channel_multiplier * unet_narrow),
            128: int(128 * channel_multiplier * unet_narrow),
            256: int(64 * channel_multiplier * unet_narrow),
            512: int(32 * channel_multiplier * unet_narrow),
            1024: int(16 * channel_multiplier * unet_narrow),
        }
        log_size = self.log_size
        first_out_size = 2 ** log_size

        self.conv_body_first = ConvLayer(3, channels[first_out_size], 1,
                                         bias=True, activate=True,
                                         dtype=dtype)
        self.conv_body_down = nn.ModuleList()
        in_ch = channels[first_out_size]
        for i in range(log_size, 2, -1):
            out_ch = channels[2 ** (i - 1)]
            self.conv_body_down.append(ResBlock(in_ch, out_ch,
                                                resample_kernel, dtype=dtype))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch, channels[4], 3, bias=True,
                                    activate=True, dtype=dtype)
        self.conv_body_up = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, log_size + 1):
            out_ch = channels[2 ** i]
            self.conv_body_up.append(ResUpBlock(in_ch, out_ch, dtype=dtype))
            in_ch = out_ch
        self.toRGB = nn.ModuleList([
            EqualConv2d(channels[2 ** i], 3, 1, stride=1, padding=0,
                        bias=True, bias_init_val=0.0, dtype=dtype)
            for i in range(3, log_size + 1)])

        linear_out = ((log_size * 2 - 2) * num_style_feat if different_w
                      else num_style_feat)
        self.final_linear = EqualLinear(
            channels[4] * 4 * 4 * self.ratio, linear_out, bias=True,
            bias_init_val=0.0, lr_mul=1.0, activation=None, dtype=dtype)

        self.stylegan_decoder = StyleGAN2OCRGenerator(
            input_width=input_width, input_height=input_height,
            num_style_feat=num_style_feat, num_mlp=num_mlp,
            channel_multiplier=channel_multiplier,
            resample_kernel=resample_kernel, lr_mlp=lr_mlp, narrow=narrow,
            sft_half=sft_half, dtype=dtype,
            with_style_mlp=not input_is_latent)

        self.condition_scale = nn.ModuleList()
        self.condition_shift = nn.ModuleList()
        for i in range(3, log_size + 1):
            out_ch = channels[2 ** i]
            sft_out = out_ch if sft_half else out_ch * 2
            self.condition_scale.append(
                sft_condition(out_ch, sft_out, 1.0, dtype=dtype))
            self.condition_shift.append(
                sft_condition(out_ch, sft_out, 0.0, dtype=dtype))

    def forward(self, x, return_latents=False, return_rgb=True,
                randomize_noise=True, noise=None, generator=None):
        conditions = []
        unet_skips = []
        out_rgbs = []

        feat = self.conv_body_first(x)
        for i in range(self.log_size - 2):
            feat = self.conv_body_down[i](feat)
            unet_skips.insert(0, feat)
        feat = self.final_conv(feat)

        # style code from the (C, H, W) flatten the reference uses
        style_code = self.final_linear(
            feat.permute(0, 3, 1, 2).reshape(feat.shape[0], -1))
        if self.different_w:
            style_code = style_code.reshape(style_code.shape[0], -1,
                                            self.num_style_feat)

        for i in range(self.log_size - 2):
            feat = feat + unet_skips[i]
            feat = self.conv_body_up[i](feat)
            conditions.append(self.condition_scale[i](feat))
            conditions.append(self.condition_shift[i](feat))
            if return_rgb:
                out_rgbs.append(self.toRGB[i](feat))

        image, _ = self.stylegan_decoder(
            [style_code], conditions, input_is_latent=self.input_is_latent,
            randomize_noise=randomize_noise, noise=noise,
            return_latents=return_latents, generator=generator)
        return image, out_rgbs
