"""Loss registry and `build_loss`."""

from copy import deepcopy

from ..utils.registry import LOSS_REGISTRY
from .losses import (CharbonnierLoss, GANLoss, L1Loss, MSELoss,
                     MultiScaleGANLoss, GANFeatLoss, PerceptualLoss,
                     SobelLoss, WeightedTVLoss, WMSELoss, g_path_regularize,
                     gradient_penalty_loss, r1_penalty)

__all__ = [
    "L1Loss", "MSELoss", "CharbonnierLoss", "SobelLoss", "WMSELoss",
    "WeightedTVLoss", "PerceptualLoss", "GANLoss", "MultiScaleGANLoss",
    "GANFeatLoss", "r1_penalty", "g_path_regularize", "gradient_penalty_loss",
    "build_loss",
]


def build_loss(opt):
    """Instantiate a loss from a config dict with a `type:` key."""
    opt = deepcopy(opt)
    loss_type = opt.pop("type")
    return LOSS_REGISTRY.get(loss_type)(**opt)
