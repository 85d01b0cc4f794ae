"""Trainer registry: `build_model` dispatches on `model_type`."""

from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY


def build_model(opt, device=None):
    """The trainer of `opt["model_type"]` on `device` (None: cuda)."""
    from . import (distill_model, esrgan_model, gfpgan_model,  # noqa: F401
                   hifacegan_model, sr_model, srgan_model,
                   stylegan2_model)  # (registration)
    opt = deepcopy(opt)
    if opt["model_type"] not in MODEL_REGISTRY:
        from . import video_models  # noqa: F401  (registered when asked)
    model = MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
    get_root_logger().info(
        f"Model [{model.__class__.__name__}] is created.")
    return model
