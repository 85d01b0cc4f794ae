"""An insightface/arcface `iresnetXX` checkpoint → the port's IResNet.

Port of `image_restoration_tpu/convert/iresnet_import.py`. The port's
IResNet keeps insightface's names, layouts and BatchNorm statistics
(`archs/iresnet_arch.py`), so where JAX folds every BatchNorm into a
scale/shift, transposes the convs and permutes `fc`'s input features, the
port loads the tensors as they are: a `.pth` path or a `state_dict` (bare,
under "state_dict", or with DDP's "module." prefix), strictly, except that
`num_batches_tracked` (which the net never reads) may be absent.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch


def import_iresnet(source: Union[str, Mapping], net: torch.nn.Module
                   ) -> torch.nn.Module:
    """Load `source` (a `.pth` path or a state_dict of tensors or arrays)
    into the port's IResNet `net` and return it."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu", weights_only=True)
    if "state_dict" in source:
        source = source["state_dict"]
    sd = {}
    for k, v in source.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = torch.as_tensor(v)
    own = net.state_dict()
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v
    net.load_state_dict(sd, strict=True)
    return net
