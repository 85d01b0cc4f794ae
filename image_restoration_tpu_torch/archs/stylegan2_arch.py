"""StyleGAN2 block set, OCR and square generators and the discriminator —
PyTorch, NHWC at every forward.

Port of `image_restoration_tpu/archs/stylegan2_arch.py:45-514`. Parameters
carry the reference checkpoint's names and layouts (convs OIHW, modulated
weights (1, O, I, k, k), ConvLayer as a Sequential whose FusedLeakyReLU holds
the activation bias), so a reference `.pth` loads with `load_state_dict`.

What differs from the JAX modules:
  * the fused bias + LeakyReLU runs kernel K1 on the GPU (ops/fused_act.py);
  * in_channels are constructor arguments (torch builds parameters eagerly);
  * noise is explicit: a list of (1|b, h, w, 1) tensors, or drawn from a
    `torch.Generator`, or none. With none, the JAX package adds zeros
    (`_prepare`, :397-404); here the add is skipped, which gives the same
    values for any finite noise weight.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.dist_util import gather_batch, rank_rows
from ..utils.registry import ARCH_REGISTRY
from ..ops import fused_act
from ..ops.fused_act import FusedLeakyReLU, ScaledLeakyReLU
from ..ops import fused_resample
from ..ops.fused_resample import conv_down_fir
from ..ops.modulated_conv import conv2d, fused_valid_conv, modulated_conv2d
from ..ops.upfirdn import upfirdn_smooth, upfirdn_upsample


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Mixed-precision entry cast: parameters stay float32, compute runs in
    `dtype` when set (the ops cast weights to the activation dtype, so one
    cast here reaches every conv of the layer). None keeps x's dtype."""
    return x if dtype is None or x.dtype == dtype else x.to(dtype)


def stylegan_channels(channel_multiplier: float, narrow: float = 1.0) -> dict:
    """Resolution → channel-count table."""
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
    }


def norm_style_code(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + 1e-8)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class NormStyleCode(nn.Module):
    def forward(self, x):
        return norm_style_code(x)


class EqualLinear(nn.Module):
    """Equalized linear. Stored weight (out, in) ~ N(0, 1/lr_mul); runtime
    scale lr_mul/sqrt(in); effective bias = bias * lr_mul."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 bias_init_val: float = 0.0, lr_mul: float = 1.0,
                 activation: Optional[str] = None, dtype=None):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if bias
                     else None)
        self.bias_init_val = bias_init_val
        self.lr_mul = lr_mul
        self.activation = activation
        self.scale = (1.0 / math.sqrt(in_channels)) * lr_mul
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init_val)

    def forward(self, x):
        x = _cast(x, self.dtype)
        out = F.linear(x, self.weight.to(x.dtype)) * self.scale
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_act.fused_leaky_relu(out, bias)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out


class EqualConv2d(nn.Module):
    """Equalized conv: weight (out, in, k, k) ~ N(0,1), scale 1/sqrt(in·k²)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 bias_init_val: float = 0.0, dtype=None, groups: int = 1):
        super().__init__()
        cig = in_channels // groups
        self.weight = nn.Parameter(torch.empty(out_channels, cig,
                                               kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if bias
                     else None)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.bias_init_val = bias_init_val
        self.scale = 1.0 / math.sqrt(cig * kernel_size ** 2)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init_val)

    def forward(self, x):
        x = _cast(x, self.dtype)
        out = conv2d(x, self.weight * self.scale, stride=self.stride,
                     padding=self.padding, groups=self.groups)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class UpFirDnSmooth(nn.Module):
    """FIR smoothing around a strided conv (no parameters)."""

    def __init__(self, resample_kernel: Sequence[int], upsample_factor: int = 1,
                 downsample_factor: int = 1, kernel_size: int = 1):
        super().__init__()
        self.resample_kernel = tuple(resample_kernel)
        self.up, self.down, self.kernel_size = (upsample_factor,
                                                downsample_factor, kernel_size)

    def forward(self, x):
        return upfirdn_smooth(x, self.resample_kernel, self.up, self.down,
                              self.kernel_size)


class ConvLayer(nn.Sequential):
    """[FIR-smooth↓] + EqualConv2d + [FusedLeakyReLU | ScaledLeakyReLU].

    A Sequential as in the reference, so its keys are `N.weight` for the
    conv and `N.bias` for the fused activation's bias. Under
    `fused_resample.FUSE_DOWN` a downsampling layer runs the smooth and
    the strided conv as one `conv_down_fir` (JAX :154-160), on the same
    parameters. `groups` splits the conv into independent channel groups
    (the stacked component discriminators); the FIR is per channel either
    way.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 downsample: bool = False,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 bias: bool = True, activate: bool = True, dtype=None,
                 groups: int = 1):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, downsample_factor=2,
                                        kernel_size=kernel_size))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channels, out_channels, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate, dtype=dtype,
                                  groups=groups))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias
                          else ScaledLeakyReLU(0.2))
        super().__init__(*layers)
        self.downsample = downsample
        self.resample_kernel = tuple(resample_kernel)
        self.dtype = dtype

    def forward(self, x):
        x = _cast(x, self.dtype)
        if not (self.downsample and fused_resample.FUSE_DOWN):
            return super().forward(x)
        conv = self[1]
        out = conv_down_fir(x, conv.weight * conv.scale, self.resample_kernel,
                            conv_fn=fused_valid_conv, groups=conv.groups)
        if conv.bias is not None:
            out = out + conv.bias.to(out.dtype)
        for layer in list(self)[2:]:
            out = layer(out)
        return out


class ResBlock(nn.Module):
    """Residual block: conv + downsample-conv + 1×1-downsample skip, /√2."""

    def __init__(self, in_channels: int, out_channels: int,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, bias=True,
                               activate=True, dtype=dtype)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel, bias=True,
                               activate=True, dtype=dtype)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, bias=False,
                              activate=False, dtype=dtype)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv: modulation linear + equalized weight
    (1, out, in, k, k) + the modulate/conv/demodulate op."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: Optional[str] = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 eps: float = 1e-8, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.modulation = EqualLinear(num_style_feat, in_channels, bias=True,
                                      bias_init_val=1.0, lr_mul=1.0,
                                      activation=None, dtype=dtype)
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.demodulate, self.sample_mode = demodulate, sample_mode
        self.resample_kernel = tuple(resample_kernel)
        self.eps = eps
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x, style):
        x = _cast(x, self.dtype)
        s = self.modulation(style)
        return modulated_conv2d(x, self.weight[0] * self.scale, s,
                                demodulate=self.demodulate,
                                sample_mode=self.sample_mode,
                                smooth_kernel=self.resample_kernel,
                                eps=self.eps)


class StyleConv(nn.Module):
    """ModulatedConv2d + noise injection + fused LeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True,
                 sample_mode: Optional[str] = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate=demodulate, sample_mode=sample_mode,
            resample_kernel=resample_kernel, dtype=dtype)
        self.weight = nn.Parameter(torch.zeros(1))  # noise strength
        self.activate = FusedLeakyReLU(out_channels)

    def reset_parameters(self, generator=None):
        self.weight.zero_()

    def forward(self, x, style, noise=None):
        out = self.modulated_conv(x, style)
        if noise is not None:
            out = out + self.weight.to(out.dtype) * noise.to(out.dtype)
        return self.activate(out)


class ToRGB(nn.Module):
    """1×1 modulated conv (no demod) to RGB + upsampled skip-add."""

    def __init__(self, in_channels: int, num_style_feat: int,
                 upsample: bool = True,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, 3, 1, num_style_feat, demodulate=False,
            sample_mode=None, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample
        self.resample_kernel = tuple(resample_kernel)

    def reset_parameters(self, generator=None):
        self.bias.zero_()

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style)
        out = out + self.bias.reshape(3).to(out.dtype)
        if skip is not None:
            if self.upsample:
                skip = upfirdn_upsample(skip, self.resample_kernel)
            out = out + skip
        return out


class ConstantInput(nn.Module):
    """Learned constant input, stored (1, C, 4, 4·ratio) as in the
    reference; forward returns it NHWC, tiled over the batch."""

    def __init__(self, num_channel: int, size_height: int, size_width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, num_channel, size_height,
                                               size_width))

    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, batch: int):
        return self.weight.permute(0, 2, 3, 1).repeat(batch, 1, 1, 1)


@ARCH_REGISTRY.register()
class StyleGAN2OCRGenerator(nn.Module):
    """Rectangle-aware StyleGAN2 generator (JAX :300-458).

    `forward(styles, conditions, ...)` takes a list of one or two
    (b, num_style_feat) codes, or one (b, num_latent, num_style_feat) of
    per-layer codes with `input_is_latent`. Two codes mix: the first
    drives the layers before `inject_index` (default num_latent // 2, as
    in JAX), the second the rest. `truncation` < 1 pulls each code towards
    `truncation_latent` (see `mean_latent`). `conditions` are the SFT
    scale/shift maps, merged between the two convs of each resolution
    (JAX :441-449). `with_style_mlp=False` leaves out the style MLP, which
    a generator fed latents never runs (its reference keys are then
    dropped on load).
    """

    def __init__(self, input_width: int = 768, input_height: int = 32,
                 num_style_feat: int = 512, num_mlp: int = 8,
                 channel_multiplier: float = 2,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01, narrow: float = 1.0,
                 sft_half: bool = False, dtype=None,
                 with_style_mlp: bool = True):
        super().__init__()
        self.input_width, self.input_height = input_width, input_height
        self.num_style_feat = num_style_feat
        self.sft_half = sft_half
        self.log_size = int(math.log2(min(input_width, input_height)))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.ratio = int(input_width / input_height)
        channels = stylegan_channels(channel_multiplier, narrow)
        self.channels = channels

        self.style_mlp = None
        if with_style_mlp:
            self.style_mlp = nn.Sequential(NormStyleCode(), *[
                EqualLinear(num_style_feat, num_style_feat, bias=True,
                            bias_init_val=0.0, lr_mul=lr_mlp,
                            activation="fused_lrelu", dtype=dtype)
                for _ in range(num_mlp)])
        self.constant_input = ConstantInput(channels[4], 4, 4 * self.ratio)
        self.style_conv1 = StyleConv(channels[4], channels[4], 3,
                                     num_style_feat, demodulate=True,
                                     sample_mode=None,
                                     resample_kernel=resample_kernel,
                                     dtype=dtype)
        self.to_rgb1 = ToRGB(channels[4], num_style_feat, upsample=False,
                             resample_kernel=resample_kernel, dtype=dtype)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2 ** i]
            self.style_convs.append(StyleConv(
                in_ch, out_ch, 3, num_style_feat, demodulate=True,
                sample_mode="upsample", resample_kernel=resample_kernel,
                dtype=dtype))
            self.style_convs.append(StyleConv(
                out_ch, out_ch, 3, num_style_feat, demodulate=True,
                sample_mode=None, resample_kernel=resample_kernel,
                dtype=dtype))
            self.to_rgbs.append(ToRGB(out_ch, num_style_feat, upsample=True,
                                      resample_kernel=resample_kernel,
                                      dtype=dtype))
            in_ch = out_ch

    def noise_shapes(self) -> list:
        shapes = []
        for layer_idx in range(self.num_layers):
            h = 2 ** ((layer_idx + 5) // 2)
            shapes.append((1, h, h * self.ratio, 1))
        return shapes

    def style_forward(self, x):
        """Style code → W latent (NormStyleCode + MLP)."""
        if self.style_mlp is None:
            raise RuntimeError("generator built with with_style_mlp=False")
        return self.style_mlp(x)

    def mean_latent(self, num_samples: int,
                    generator: Optional[torch.Generator] = None):
        """The mean W latent of `num_samples` codes drawn from `generator`
        on the parameters' device, (1, num_style_feat)."""
        dev = self.constant_input.weight.device
        z = torch.randn((num_samples, self.num_style_feat),
                        generator=generator, device=dev)
        return self.style_forward(z).mean(dim=0, keepdim=True)

    def latent_codes(self, styles, input_is_latent=False, truncation=1.0,
                     truncation_latent=None, inject_index=None):
        """The (b, num_latent, num_style_feat) latent of the forward: the
        style MLP (unless `input_is_latent`), truncation, and the tiling or
        mixing of one or two codes (JAX `_prepare`, :393-423)."""
        if not input_is_latent:
            styles = [self.style_forward(s) for s in styles]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if len(styles) == 1:
            if styles[0].dim() < 3:
                return styles[0][:, None, :].repeat(1, self.num_latent, 1)
            return styles[0]
        if len(styles) == 2:
            if inject_index is None:
                inject_index = self.num_latent // 2
            return torch.cat([
                styles[0][:, None, :].repeat(1, inject_index, 1),
                styles[1][:, None, :].repeat(
                    1, self.num_latent - inject_index, 1)], dim=1)
        raise ValueError("styles must have 1 or 2 entries")

    def forward(self, styles, conditions=None, input_is_latent=False,
                noise=None, randomize_noise=True, truncation=1.0,
                truncation_latent=None, inject_index=None,
                return_latents=False, generator=None):
        latent = self.latent_codes(styles, input_is_latent, truncation,
                                   truncation_latent, inject_index)
        if noise is None:
            if randomize_noise and generator is not None:
                noise = [torch.randn(s, generator=generator,
                                     device=latent.device)
                         for s in self.noise_shapes()]
            else:
                noise = [None] * self.num_layers
        out = self.constant_input(latent.shape[0])
        out = self.style_conv1(out, latent[:, 0], noise=noise[0])
        skip = self.to_rgb1(out, latent[:, 1])

        i = 1
        for idx in range(len(self.to_rgbs)):
            conv1 = self.style_convs[2 * idx]
            conv2 = self.style_convs[2 * idx + 1]
            out = conv1(out, latent[:, i], noise=noise[2 * idx + 1])
            if conditions is not None and i < len(conditions):
                if self.sft_half:
                    half = out.shape[-1] // 2
                    out_same, out_sft = out[..., :half], out[..., half:]
                    out_sft = out_sft * conditions[i - 1] + conditions[i]
                    out = torch.cat([out_same, out_sft], dim=-1)
                else:
                    out = out * conditions[i - 1] + conditions[i]
            out = conv2(out, latent[:, i + 1], noise=noise[2 * idx + 2])
            skip = self.to_rgbs[idx](out, latent[:, i + 2], skip)
            i += 2

        if return_latents:
            return skip, latent
        return skip, None


@ARCH_REGISTRY.register()
class StyleGAN2Generator(StyleGAN2OCRGenerator):
    """The square generator, under the reference's `out_size` (JAX
    :463-470); `build_network` turns `out_size` into the width and the
    height, as the JAX builder does."""

    def __init__(self, out_size: Optional[int] = None, **kwargs):
        if out_size is not None:
            kwargs.setdefault("input_width", out_size)
            kwargs.setdefault("input_height", out_size)
        super().__init__(**kwargs)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """StyleGAN2 D with minibatch stddev (JAX `stylegan2_arch.py:473`).

    Reference layout: `conv_body` (a 1×1 ConvLayer, then a ResBlock per
    halving down to 4²), `final_conv` over the features plus the stddev
    channel, and `final_linear` (a fused-lrelu EqualLinear, then one to a
    logit). The final flatten is (C, H, W), as in the reference, so a
    reference `net_d` loads; the JAX module flattens (H, W, C) and its
    importer permutes. In a `torch.distributed` world the stddev groups
    are those of the global batch, as under JAX's sharded batch.
    """

    def __init__(self, input_width: int = 256, input_height: int = 256,
                 channel_multiplier: float = 2,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 stddev_group: int = 4, narrow: float = 1.0, dtype=None):
        super().__init__()
        channels = stylegan_channels(channel_multiplier, narrow)
        out_size = min(input_width, input_height)
        log_size = int(math.log2(out_size))
        self.ratio = int(input_width / input_height)
        self.stddev_group = stddev_group
        body = [ConvLayer(3, channels[out_size], 1, bias=True,
                          activate=True, dtype=dtype)]
        in_ch = channels[out_size]
        for i in range(log_size, 2, -1):
            out_ch = channels[2 ** (i - 1)]
            body.append(ResBlock(in_ch, out_ch, resample_kernel,
                                 dtype=dtype))
            in_ch = out_ch
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(in_ch + 1, channels[4], 3, bias=True,
                                    activate=True, dtype=dtype)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4 * self.ratio, channels[4],
                        bias=True, bias_init_val=0.0, lr_mul=1.0,
                        activation="fused_lrelu", dtype=dtype),
            EqualLinear(channels[4], 1, bias=True, bias_init_val=0.0,
                        lr_mul=1.0, activation=None, dtype=dtype))

    def forward(self, x):
        out = self.conv_body(x)
        b_local = out.shape[0]
        out = gather_batch(out)  # in a world the global batch's statistic
        b, h, w, c = out.shape
        group = min(b, self.stddev_group)
        grouped = out.reshape(group, b // group, h, w, c)
        stddev = torch.sqrt(grouped.var(dim=0, unbiased=False) + 1e-8)
        stddev = stddev.mean(dim=(1, 2, 3))            # (b // group,)
        stat = stddev.repeat(group)[:, None, None, None]
        out = torch.cat([out, stat.expand(b, h, w, 1).to(out.dtype)], dim=-1)
        if b != b_local:  # this rank's rows
            out = rank_rows(out, b)
            b = b_local
        out = self.final_conv(out)
        out = out.permute(0, 3, 1, 2).reshape(b, -1)   # (C, H, W) flatten
        return self.final_linear(out)
