"""Architecture registry + builder.

`build_network(opt)` dispatches on the same `type:` names as
`image_restoration_tpu/archs/__init__.py` and initialises the parameters
from a seeded `torch.Generator`, on the CPU (move the net afterwards).
"""

from copy import deepcopy

import torch

from ..utils.registry import ARCH_REGISTRY
from . import stylegan2_arch  # noqa: F401
from . import gfpgan_ocr_arch  # noqa: F401
from . import gfpganv1_arch  # noqa: F401
from . import iresnet_arch  # noqa: F401
from . import srvgg_arch  # noqa: F401
from . import rrdbnet_arch  # noqa: F401
from . import retinaface_arch  # noqa: F401
from . import vgg_arch  # noqa: F401
from . import discriminator_arch  # noqa: F401
from . import hifacegan_arch  # noqa: F401
from . import inception_arch  # noqa: F401
from . import edsr_arch  # noqa: F401
from . import srresnet_arch  # noqa: F401
from . import rcan_arch  # noqa: F401
from . import ridnet_arch  # noqa: F401
from . import dfdnet_arch  # noqa: F401
from . import spynet_arch  # noqa: F401
from . import edvr_arch  # noqa: F401
from . import basicvsr_arch  # noqa: F401
from . import duf_arch  # noqa: F401
from . import tof_arch  # noqa: F401

_DTYPE_ALIASES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "f16": torch.float16, "float16": torch.float16, "fp16": torch.float16,
}


@torch.no_grad()
def init_weights(net: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from `generator` (CPU) with each layer's init."""
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def build_network(opt, generator: torch.Generator | None = None):
    """Instantiate a module from a config dict with a `type:` key.

    Accepts the square `out_size` spelling for the rectangle-aware archs and
    dtype strings ("bf16", "float32", ...). Parameters are drawn from
    `generator`, or from a generator seeded with 0; then a submodule that
    names a reference `.pth` (SpyNet's and EDVRFeatureExtractor's
    `load_path`) loads it.
    """
    opt = deepcopy(opt)
    network_type = opt.pop("type")
    cls = ARCH_REGISTRY.get(network_type)
    # a train-mode BatchNorm's statistics are always the global batch's
    # (over a torch.distributed world too), as in JAX: syncbn has no role
    opt.pop("syncbn", None)
    if "out_size" in opt:
        size = opt.pop("out_size")
        opt.setdefault("input_width", size)
        opt.setdefault("input_height", size)
    if isinstance(opt.get("dtype"), str):
        try:
            opt["dtype"] = _DTYPE_ALIASES[opt["dtype"]]
        except KeyError:
            raise ValueError(
                f"unknown dtype {opt['dtype']!r} for network type "
                f"{network_type!r}; valid spellings: "
                f"{sorted(_DTYPE_ALIASES)}") from None
    opt = {k: tuple(v) if isinstance(v, list) else v for k, v in opt.items()}
    net = cls(**opt)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    for m in net.modules():  # a reference `.pth` the options name
        if hasattr(m, "load_pretrained"):
            m.load_pretrained()
    return net
