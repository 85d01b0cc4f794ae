"""Reference `.pth` checkpoints → the port's `state_dict`.

The counterpart of the JAX package's `load_pth` + `import_network`
(`infer.py:73-76`): the port keeps the reference's names and layouts, so the
only work is picking the parameter set and dropping what the port does not
hold — the fixed noise buffers, and the style MLP of a net fed latents.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

_DROP_ALWAYS = (r"^(stylegan_decoder\.)?noises\.",)


def load_pth(path: str, param_key: Optional[str] = "params",
             input_is_latent: bool = False) -> dict:
    """Load a checkpoint dict of tensors ({'params', 'params_ema'} or a bare
    state_dict) and return the state_dict the port's net loads strictly.
    Asked for one of params/params_ema, a checkpoint holding only the other
    gives that one."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        other = {"params": "params_ema", "params_ema": "params"}
        if param_key is not None and param_key in ckpt:
            ckpt = ckpt[param_key]
        elif other.get(param_key) in ckpt:  # Real-ESRGAN ships only one
            ckpt = ckpt[other[param_key]]
        elif "state_dict" in ckpt:
            ckpt = ckpt["state_dict"]
    drop = list(_DROP_ALWAYS)
    if input_is_latent:
        drop.append(r"(^|\.)style_mlp\.")
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):  # DDP prefix
            k = k[len("module."):]
        if any(re.search(p, k) for p in drop):
            continue
        out[k] = v
    return out
