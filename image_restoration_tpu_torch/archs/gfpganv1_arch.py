"""GFPGANv1 (the square front) and the component discriminator.

Port of `image_restoration_tpu/archs/gfpganv1_arch.py:26-59`:

  * `GFPGANv1` is GFPGANv1OCR at ratio 1, built through `from_out_size`;
  * `FacialComponentDiscriminator` is the VGG-style D of one component
    (here a plate character): five `ConvLayer`s with the fused bias +
    LeakyReLU (K1 on the GPU) — 3→64, 64→128 ↓, 128→128, 128→256 ↓,
    256→256 — then `final_conv`, a plain 3×3 conv 256→1 with a bias, as in
    JAX (not an equalized ConvLayer). It returns (logits, [features after
    conv3, features after conv5]) with `return_feats`, else (logits, None).

`groups` stacks that many independent Ds into one module, each layer a
grouped conv: input channel block q (3 channels) goes through D number q
only, and every output is the groups' blocks side by side. GFPGANModel
holds its ten char Ds so (JAX holds them as one parameter tree stacked on a
leading axis and `jax.vmap`s the apply): a pass over all ten chars is five
K1 launches, not fifty, and one Adam over the stacked parameters is, per
element, ten Adams. At groups=1 the keys are the reference's
(`conv1.0.weight`, `conv1.1.bias`, `conv2.1.weight`, …,
`final_conv.0.weight`); at groups=G each tensor is the G per-D tensors
concatenated on axis 0, so `char_state_dict(i)` / `load_char(i, sd)` read
and write D number i in that layout (a reference `pretrain_network_d_char_i`
`.pth`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..ops.modulated_conv import conv2d
from ..utils.registry import ARCH_REGISTRY
from .gfpgan_ocr_arch import GFPGANv1OCR
from .stylegan2_arch import ConvLayer, _cast


@ARCH_REGISTRY.register()
class GFPGANv1(GFPGANv1OCR):
    """The square out_size² generator (GFPGANv1OCR at ratio 1)."""

    @classmethod
    def from_out_size(cls, out_size: int = 512, **kwargs):
        return cls(input_width=out_size, input_height=out_size, **kwargs)


class _PlainConv(nn.Conv2d):
    """flax `nn.Conv` over NHWC: the weight is used as stored (no
    equalized scale), lecun-normal scale at init, zero bias."""

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight[0].numel()),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x):
        out = conv2d(x, self.weight, padding=self.padding[0],
                     groups=self.groups)
        return out + self.bias.to(out.dtype)


@ARCH_REGISTRY.register()
class FacialComponentDiscriminator(nn.Module):
    """`groups` component Ds side by side; x is (N, H, W, 3·groups)."""

    def __init__(self, groups: int = 1, dtype=None):
        super().__init__()
        g = self.groups = groups

        def layer(cin, cout, down=False):
            return ConvLayer(cin * g, cout * g, 3, downsample=down,
                             bias=True, activate=True, dtype=dtype, groups=g)

        self.conv1 = layer(3, 64)
        self.conv2 = layer(64, 128, down=True)
        self.conv3 = layer(128, 128)
        self.conv4 = layer(128, 256, down=True)
        self.conv5 = layer(256, 256)
        # a Sequential, so its keys are the reference's final_conv.0.*
        self.final_conv = nn.Sequential(
            _PlainConv(256 * g, g, 3, padding=1, groups=g))
        self.dtype = dtype

    def forward(self, x, return_feats: bool = False):
        x = _cast(x, self.dtype)
        feat = self.conv3(self.conv2(self.conv1(x)))
        feats = [feat]
        feat = self.conv5(self.conv4(feat))
        feats.append(feat)
        out = self.final_conv(feat)
        return out, (feats if return_feats else None)

    def forward_stacked(self, crops: torch.Tensor,
                        return_feats: bool = False):
        """D number q on crops[q]: crops (groups, N, S, S, 3) → logits
        (groups, N, s, s, 1) and, with `return_feats`, the two feature maps
        as (groups, N, h, w, C) views."""
        g, n, h, w, c = crops.shape
        x = crops.permute(1, 2, 3, 0, 4).reshape(n, h, w, g * c)
        out, feats = self.forward(x, return_feats)
        if feats is not None:
            feats = [unstack_groups(f, g) for f in feats]
        return unstack_groups(out, g), feats

    # ----------------------------------------------- one D of the stack

    def char_state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """D number i in the single-D (reference) layout."""
        g = self.groups
        return {k: v.reshape(g, v.shape[0] // g, *v.shape[1:])[i].clone()
                for k, v in self.state_dict().items()}

    @torch.no_grad()
    def load_char(self, i: int, state_dict: Dict[str, torch.Tensor]) -> None:
        """Write a single-D `state_dict` into D number i (strict)."""
        own = self.state_dict()
        if set(own) != set(state_dict):
            raise KeyError(f"keys differ: missing "
                           f"{sorted(set(own) - set(state_dict))}, "
                           f"unexpected {sorted(set(state_dict) - set(own))}")
        g = self.groups
        for k, v in own.items():
            part = v.reshape(g, v.shape[0] // g, *v.shape[1:])[i]
            src = torch.as_tensor(state_dict[k])
            if tuple(src.shape) != tuple(part.shape):
                raise ValueError(f"{k}: {tuple(src.shape)} != "
                                 f"{tuple(part.shape)}")
            part.copy_(src)


def unstack_groups(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, h, w, groups·C) → (groups, N, h, w, C), a view."""
    n, h, w, gc = t.shape
    return t.reshape(n, h, w, groups, gc // groups).permute(3, 0, 1, 2, 4)
