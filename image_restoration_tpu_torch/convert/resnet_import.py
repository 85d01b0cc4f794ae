"""A torchvision resnet18/50 checkpoint → the RetinaFace detector's trunk.

Port of `image_restoration_tpu/convert/resnet_import.py:17-38`, the
detector trainer's `resnet_pretrain_path` (the reference's pretrained
trunk, Plate_Detect retinaface.py:95-100). The port's ResNet trunk keeps
torchvision's names under `body.`, so each tensor goes in as it is; the
classifier (`fc.*`) and `num_batches_tracked` are dropped. The rest of the
detector (FPN, SSH, heads) keeps its own weights.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

from .pth import load_pth


def load_torchvision_resnet(source: Union[str, Mapping],
                            net: torch.nn.Module,
                            backbone_name: str = "body") -> torch.nn.Module:
    """Copy `source` (a torchvision `.pth` path or state_dict) into
    `net.<backbone_name>` and return `net`. A key the trunk does not hold,
    or a tensor of another shape, raises."""
    if isinstance(source, str):
        source = load_pth(source, param_key=None)
    own = net.state_dict()
    sd = {}
    for k, v in source.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        key = f"{backbone_name}.{k}"
        if key not in own:
            raise KeyError(f"{key} is not a key of the detector's trunk")
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} in the "
                             f"checkpoint, {tuple(own[key].shape)} in the net")
        sd[key] = v
    net.load_state_dict(sd, strict=False)
    return net
