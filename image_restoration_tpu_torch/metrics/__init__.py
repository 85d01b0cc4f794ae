"""Metric registry: `calculate_metric` dispatches on the `type:` key to
PSNR, SSIM, NIQE, LPIPS or FID (`calculate_fid`, on feature statistics)."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .fid import calculate_fid  # noqa: F401
from .lpips import calculate_lpips  # noqa: F401
from .niqe import calculate_niqe  # noqa: F401
from .psnr_ssim import calculate_psnr, calculate_ssim  # noqa: F401

__all__ = ["calculate_psnr", "calculate_ssim", "calculate_niqe",
           "calculate_lpips", "calculate_fid", "calculate_metric"]


def calculate_metric(data, opt):
    """Dispatch on opt['type'] with the data dict's kwargs."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
