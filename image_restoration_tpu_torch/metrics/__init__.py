"""Metric registry: `calculate_metric` dispatches on the `type:` key.
NIQE, LPIPS and FID are not ported yet."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_psnr, calculate_ssim  # noqa: F401

__all__ = ["calculate_psnr", "calculate_ssim", "calculate_metric"]


def calculate_metric(data, opt):
    """Dispatch on opt['type'] with the data dict's kwargs."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
