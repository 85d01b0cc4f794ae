"""A BasicSR DFDNet checkpoint and its facial dictionary → the port's
DFDNet.

Port of `image_restoration_tpu/convert/dfdnet_import.py:26-48`. Every conv
of the reference but the VGG's and `upsample4`'s last three is wrapped in
spectral norm, so a checkpoint stores (`weight_orig`, `weight_u`,
`weight_v`) triples; `fold_spectral_norm` makes W/σ from them, in float64,
as JAX does. The reference's VGG sits in a Sequential named by layer
(`vgg_extractor.vgg_net.conv1_1.weight`), which maps onto the port's
torchvision indices (`vgg_extractor.features.0.weight`); its mean/std
buffers are constants here and are dropped.

The dictionary lives outside the checkpoint in the reference
(`torch.load(dict_path)`: {'256': {part: (K, C, h, w)}}); `load_dfdnet_dict`
turns it into the NHWC atoms the forward takes.

`dfdnet_reference_state_dict` goes the other way: the port's net as a
BasicSR checkpoint, each wrapped conv's weight written as a triple whose
fold gives the weight back, for tests and for the smoke run.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .hifacegan_import import fold_spectral_norm
from .pth import load_pth

_VGG_REF = re.compile(r"^vgg_extractor\.vgg_net\.(\w+)\.(weight|bias)$")
_VGG_PORT = re.compile(r"^vgg_extractor\.features\.(\d+)\.(weight|bias)$")
_SN_PREFIXES = ("attn_blocks.", "multi_scale_dilation.", "upsample0.",
                "upsample1.", "upsample2.", "upsample3.", "upsample4.0.")
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _vgg_names():
    from ..archs.vgg_arch import vgg_layer_names
    return vgg_layer_names("vgg19")


def dfdnet_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A reference DFDNet state_dict (tensors or arrays) → the port's:
    spectral norm folded, the VGG's names mapped, mean/std dropped."""
    names = _vgg_names()
    out = {}
    for k, v in fold_spectral_norm(state_dict).items():
        if k in ("vgg_extractor.mean", "vgg_extractor.std"):
            continue
        m = _VGG_REF.match(k)
        if m:
            k = f"vgg_extractor.features.{names.index(m.group(1))}." \
                f"{m.group(2)}"
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_dfdnet(path: str, net: torch.nn.Module,
                param_key: Optional[str] = None) -> torch.nn.Module:
    """Load a BasicSR DFDNet `.pth` (bare, or under `param_key`) into
    `net` strictly; returns `net`."""
    net.load_state_dict(dfdnet_state_dict(load_pth(path, param_key)),
                        strict=True)
    return net


def load_dfdnet_dict(src, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's dictionary ({'256': {part: (K, C, h, w)}}, or a
    `.pth` path holding it) → {'256': {part: (K, h, w, C) float32}} on
    `device` (None: cuda), JAX's `convert_dfdnet_dict`."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if isinstance(src, str):
        src = torch.load(src, map_location="cpu", weights_only=True)
    return {str(size): {
        part: torch.as_tensor(np.asarray(v, np.float32)).permute(
            0, 2, 3, 1).contiguous().to(dev)
        for part, v in parts.items()} for size, parts in src.items()}


def _wrapped(key: str) -> bool:
    return key.endswith(".weight") and key.startswith(_SN_PREFIXES)


def dfdnet_reference_state_dict(
        net: torch.nn.Module,
        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The port's DFDNet as a BasicSR checkpoint (CPU tensors): VGG names,
    mean/std buffers, and a spectral-norm triple for each wrapped conv:
    weight_orig = c·W (c drawn in [0.5, 2]), v = v₀/‖W·v₀‖ and u = W·v (a
    unit vector, as after a power step), so that W_orig/(uᵀ·W_orig·v) = W."""
    g = generator or torch.Generator().manual_seed(0)
    names = _vgg_names()
    out = {}
    for k, v in net.state_dict().items():
        v = v.detach().cpu()
        m = _VGG_PORT.match(k)
        if m:
            out[f"vgg_extractor.vgg_net.{names[int(m.group(1))]}."
                f"{m.group(2)}"] = v
        elif _wrapped(k):
            w = v.double().reshape(v.shape[0], -1)
            v0 = torch.randn(w.shape[1], generator=g, dtype=torch.float64)
            vv = v0 / torch.linalg.vector_norm(w @ v0)
            c = 0.5 + 1.5 * torch.rand((), generator=g, dtype=torch.float64)
            base = k[: -len("weight")]
            out[base + "weight_orig"] = (c * v.double()).float()
            out[base + "weight_u"] = (w @ vv).float()
            out[base + "weight_v"] = vv.float()
        else:
            out[k] = v
    out["vgg_extractor.mean"] = torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
    out["vgg_extractor.std"] = torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1)
    return out
