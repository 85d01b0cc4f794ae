"""A BasicSR HiFaceGAN checkpoint → the port's HiFaceGAN nets.

Port of `image_restoration_tpu/convert/hifacegan_import.py:21-47`. BasicSR
wraps its convs in torch's spectral_norm (hifacegan_util.py:78-90), so a
checkpoint stores `weight_orig` and the power-iteration vectors
`weight_u`/`weight_v`; at eval torch computes W_orig/σ with σ = uᵀ·W·v
from the stored vectors. `fold_spectral_norm` makes that weight, in
float64, as JAX's does. The port's nets keep BasicSR's names, and their
convs fold a triple through it as they read one, so a BasicSR checkpoint
loads strictly by any path (`load_hifacegan`, or a model's
`load_pretrain_torch`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .pth import load_pth


def fold_spectral_norm(state_dict: Mapping) -> Dict:
    """Replace each (weight_orig, weight_u, weight_v) triple with the
    spectral-normalized weight (float32, σ in float64); other keys pass
    through. Arrays or tensors in, numpy arrays out."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("weight_orig"):
            base = k[: -len("_orig")]
            w = np.asarray(v, np.float64)
            u = np.asarray(state_dict[base + "_u"], np.float64)
            vv = np.asarray(state_dict[base + "_v"], np.float64)
            sigma = u @ w.reshape(w.shape[0], -1) @ vv
            out[base] = (w / sigma).astype(np.float32)
        elif k.endswith(("weight_u", "weight_v")):
            continue
        else:
            out[k] = np.asarray(v)
    return out


def load_hifacegan(path: str, net: torch.nn.Module,
                   param_key: str = "params") -> torch.nn.Module:
    """Load a BasicSR HiFaceGAN/SPADEGenerator/HiFaceGANDiscriminator
    `.pth` (under `param_key`, or bare) into `net` strictly, its spectral
    norm folded; returns `net`."""
    net.load_state_dict(load_pth(path, param_key), strict=True)
    return net
