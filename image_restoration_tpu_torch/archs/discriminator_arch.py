"""VGG-style discriminators (SRGAN/ESRGAN) and the spectral-norm UNet
discriminator.

Port of `image_restoration_tpu/archs/discriminator_arch.py` (whole), NHWC
at the forward, with the reference checkpoint's keys (`conv0_0`, `conv0_1`,
`bn0_1`, ..., `linear1`, `linear2`; a spectral-norm conv's weight is
`weight_orig`).

BatchNorm follows flax's (`momentum=0.9`, biased variance from
E[x²] − E[x]²), not `nn.BatchNorm2d`'s: in train mode a forward normalizes
with the batch's statistics and leaves the running ones alone, as JAX's
trainer runs D in every training call; `forward(x, refresh_stats=True)`
also moves them, running ← 0.9·running + 0.1·batch, which the trainer does
once per step from the GT and once from the detached output
(`SRGANModel._refresh_d_stats`). In eval mode it normalizes with the
running statistics.

`SpectralConv` is JAX's stateless spectral norm: σ from three power
iterations out of a fixed start vector at every forward, detached; not
`torch.nn.utils.spectral_norm`, which keeps a persistent `u`. A reference
checkpoint's `weight_u` and `weight_v` are ignored on load.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from ..utils.dist_util import world_mean
from ..utils.registry import ARCH_REGISTRY


def _lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


class _Conv(nn.Conv2d):
    """A conv over NHWC with kaiming normal init (fan-in, gain √2) and zero
    bias, drawn from the generator `build_network` passes."""

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / self.weight[0].numel())
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                        self.stride, self.padding).permute(0, 2, 3, 1)


class _Linear(nn.Linear):
    """A dense layer with lecun normal init and zero bias."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(1.0 / self.in_features),
                                generator=generator)
            self.bias.zero_()


class _BatchNorm(nn.BatchNorm2d):
    """flax's BatchNorm over the last axis of NHWC (see the module
    docstring)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x, refresh_stats: bool = False):
        if self.training:  # the global batch's moments in a world
            mean = world_mean(x.mean(dim=(0, 1, 2)))
            var = torch.clamp(world_mean((x * x).mean(dim=(0, 1, 2)))
                              - mean * mean, min=0.0)
            if refresh_stats:
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean
                                            + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var
                                           + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class _VGGStyleDiscriminator(nn.Module):
    """conv0_0 … conv{n}_1 with BatchNorm, then two linear heads."""

    input_size = 128

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64):
        super().__init__()
        self.num_stages = int(math.log2(self.input_size)) - 2  # 128→5
        feat_mult = [1, 2, 4, 8, 8, 8, 8]
        nf = num_feat
        self.conv0_0 = _Conv(num_in_ch, nf, 3, 1, 1, bias=True)
        self.conv0_1 = _Conv(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = _BatchNorm(nf)
        cin = nf
        for s in range(1, self.num_stages):
            f = nf * feat_mult[min(s, 3)]
            setattr(self, f"conv{s}_0", _Conv(cin, f, 3, 1, 1, bias=False))
            setattr(self, f"bn{s}_0", _BatchNorm(f))
            setattr(self, f"conv{s}_1", _Conv(f, f, 4, 2, 1, bias=False))
            setattr(self, f"bn{s}_1", _BatchNorm(f))
            cin = f
        self.linear1 = _Linear(cin * 4 * 4, 100)
        self.linear2 = _Linear(100, 1)

    def forward(self, x: torch.Tensor,
                refresh_stats: bool = False) -> torch.Tensor:
        """(N, S, S, C) → (N, 1) logits; S the input size."""
        if x.shape[1] != self.input_size or x.shape[2] != self.input_size:
            raise ValueError(f"input spatial size must be {self.input_size},"
                             f" got {tuple(x.shape[1:3])}")
        h = _lrelu(self.conv0_0(x))
        h = _lrelu(self.bn0_1(self.conv0_1(h), refresh_stats))
        for s in range(1, self.num_stages):
            for j in range(2):
                conv = getattr(self, f"conv{s}_{j}")
                bn = getattr(self, f"bn{s}_{j}")
                h = _lrelu(bn(conv(h), refresh_stats))
        # the reference flattens NCHW: features in (C, H, W) order
        h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
        return self.linear2(_lrelu(self.linear1(h)))


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator128(_VGGStyleDiscriminator):
    input_size = 128


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator256(_VGGStyleDiscriminator):
    input_size = 256


class SpectralConv(nn.Module):
    """A conv over NHWC whose weight is divided by its spectral norm σ,
    estimated by `power_iters` power iterations from a fixed start vector at
    every forward (σ detached)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True,
                 power_iters: int = 3):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.power_iters = power_iters
        self.weight_orig = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / self.weight_orig[0].numel())
        with torch.no_grad():
            self.weight_orig.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torch's spectral_norm keeps its power-iteration vectors; σ here
        # is recomputed from a fixed start at every forward
        for key in ("weight_u", "weight_v"):
            state_dict.pop(prefix + key, None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def sigma(self) -> torch.Tensor:
        """σ of the (k·k·Cin, Cout) matrix, rows in flax's (h, w, i) order
        (the same σ in any order)."""
        w = self.weight_orig.detach()
        cout = w.shape[0]
        wm = w.permute(2, 3, 1, 0).reshape(-1, cout)
        u = torch.full((cout,), 1.0 / math.sqrt(cout), dtype=w.dtype,
                       device=w.device)
        for _ in range(self.power_iters):
            v = wm @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = wm.T @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        return v @ (wm @ u)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_orig / self.sigma()
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                     self.stride, self.padding).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """Real-ESRGAN's UNet discriminator with spectral norm: (N, H, W, C) →
    (N, H, W, 1) per-pixel logits (H and W multiples of 8)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = _Conv(num_in_ch, nf, 3, 1, 1, bias=True)
        self.conv1 = SpectralConv(nf, nf * 2, 4, 2, 1, bias=False)
        self.conv2 = SpectralConv(nf * 2, nf * 4, 4, 2, 1, bias=False)
        self.conv3 = SpectralConv(nf * 4, nf * 8, 4, 2, 1, bias=False)
        self.conv4 = SpectralConv(nf * 8, nf * 4, 3, 1, 1, bias=False)
        self.conv5 = SpectralConv(nf * 4, nf * 2, 3, 1, 1, bias=False)
        self.conv6 = SpectralConv(nf * 2, nf, 3, 1, 1, bias=False)
        self.conv7 = SpectralConv(nf, nf, 3, 1, 1)
        self.conv8 = SpectralConv(nf, nf, 3, 1, 1)
        self.conv9 = SpectralConv(nf, 1, 3, 1, 1)

    @staticmethod
    def _up2(x):
        return resize(x, (x.shape[1] * 2, x.shape[2] * 2), "bilinear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = _lrelu(self.conv0(x))
        x1 = _lrelu(self.conv1(x0))
        x2 = _lrelu(self.conv2(x1))
        x3 = _lrelu(self.conv3(x2))
        x4 = _lrelu(self.conv4(self._up2(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv5(self._up2(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv6(self._up2(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv7(x6))
        out = _lrelu(self.conv8(out))
        return self.conv9(out)
