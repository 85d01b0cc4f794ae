"""The FFHQ-style degradation pipeline on the device.

Port of `image_restoration_tpu/data/pipelines.py:38-136`
(`FFHQDegradationConfig`, `make_ffhq_degradation`), the production
training chain, in the same order of stages: blur (a mixed kernel per
sample, the pyblur bank, median/bilateral where drawn) → random ↓ →
gaussian noise → JPEG (both at the low resolution) → ↑ back → colour
jitter → gray → pt-style jitter → uint8 round trip → normalize.

`make_ffhq_degradation(cfg)` gives an `FFHQDegradation`: `sample(generator,
n, h, w)` draws every parameter of a batch, `apply(gt, params)` degrades
with them, and calling it does both. The Real-ESRGAN chain (JAX `:139-300`)
is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import degradations as D
from .pyblur_bank import build_pyblur_bank
from ..ops.filter2d import filter2d
from ..utils.device import DeviceConstants


@dataclass(frozen=True)
class FFHQDegradationConfig:
    """The production chain's options, with the JAX dataclass's defaults."""
    blur_kernel_size: int = 21
    min_kernel_size: int = 11
    kernel_list: Tuple[str, ...] = ("iso", "aniso", "motion", "average",
                                    "median", "bilateral", "pyblur")
    kernel_prob: Tuple[float, ...] = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.4)
    blur_sigma: Tuple[float, float] = (0.1, 10.0)
    downsample_range: Tuple[float, float] = (4.0, 12.0)
    noise_range: Optional[Tuple[float, float]] = (0.0, 20.0)
    jpeg_range: Optional[Tuple[float, float]] = (30.0, 100.0)
    color_jitter_prob: Optional[float] = 0.3
    color_jitter_shift: float = 20.0 / 255.0
    color_jitter_pt_prob: Optional[float] = 0.3
    gray_prob: float = 0.01
    gt_gray: bool = False
    use_hflip: bool = False
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # cap on the batch elements the median/bilateral filters run on
    # (degradations._slotted_apply); None = the whole batch
    nonlinear_slots: Optional[int] = None


def _bank(device):
    return torch.as_tensor(build_pyblur_bank(), device=device)


_banks = DeviceConstants(_bank, maxsize=4)


class FFHQDegradation:
    """degrade(generator, gt) → (lq, gt), both normalized; gt (N, H, W, C)
    RGB in [0, 1] on the generator's device."""

    def __init__(self, cfg: FFHQDegradationConfig):
        self.cfg = cfg
        self.uses_bank = ("pyblur" in cfg.kernel_list
                          or "sinc" in cfg.kernel_list)
        self.bank_size = (build_pyblur_bank().shape[0] if self.uses_bank
                          else None)

    def bank(self, device) -> Optional[torch.Tensor]:
        return _banks(torch.device(device)) if self.uses_bank else None

    def sample(self, generator: torch.Generator, n: int, h: int, w: int,
               c: int = 3) -> Dict:
        """Every random parameter of one batch, drawn from `generator`."""
        cfg = self.cfg
        p: Dict = {}
        if cfg.use_hflip:
            p["flip"] = D.sample_gate(generator, n, 0.5)
        p["kernel"] = D.sample_mixed_kernel(
            generator, n, cfg.kernel_prob,
            kernel_size_range=(cfg.min_kernel_size, cfg.blur_kernel_size),
            sigma_x_range=cfg.blur_sigma, sigma_y_range=cfg.blur_sigma,
            bank_size=self.bank_size)
        if "bilateral" in cfg.kernel_list:
            p["bilateral_sigma"] = D.sample_nonlinear_blur(generator)
        if cfg.noise_range is not None:
            mid_h = int(math.ceil(h / cfg.downsample_range[0]))
            mid_w = int(math.ceil(w / cfg.downsample_range[0]))
            p["noise"] = D.sample_gaussian_noise(
                generator, (n, mid_h, mid_w, c), cfg.noise_range, 0.0)
        if cfg.jpeg_range is not None:
            p["jpeg_quality"] = D.sample_jpeg_quality(generator, n,
                                                      cfg.jpeg_range)
        p["down_scale"] = D.sample_down_up_scale(generator, n,
                                                 cfg.downsample_range)
        if cfg.color_jitter_prob is not None:
            p["jitter_gate"] = D.sample_gate(generator, n,
                                             cfg.color_jitter_prob)
            p["jitter"] = D.sample_color_jitter(generator, n,
                                                cfg.color_jitter_shift)
        if cfg.gray_prob:
            p["gray"] = D.sample_gate(generator, n, cfg.gray_prob)
        if cfg.color_jitter_pt_prob is not None:
            p["jitter_pt_gate"] = D.sample_gate(generator, n,
                                                cfg.color_jitter_pt_prob)
            p["jitter_pt"] = D.sample_color_jitter_pt(generator, n)
        return p

    def apply(self, gt: torch.Tensor, p: Dict):
        """Degrade `gt` with the drawn parameters `p`."""
        cfg = self.cfg
        if cfg.use_hflip:
            gt = torch.where(p["flip"], torch.flip(gt, dims=(2,)), gt)

        kernels = D.mixed_kernel(p["kernel"], cfg.kernel_list,
                                 cfg.blur_kernel_size, self.bank(gt.device))
        lq = filter2d(gt, kernels)
        lq = D.apply_nonlinear_blur(
            lq, p["kernel"]["type_idx"], cfg.kernel_list,
            p.get("bilateral_sigma"), ksize=min(cfg.blur_kernel_size, 15),
            slots=cfg.nonlinear_slots)

        def mid(small, valid_hw):
            if cfg.noise_range is not None:
                small = D.add_gaussian_noise(small, p["noise"])
            if cfg.jpeg_range is not None:
                small = D.add_jpeg_compression(small, p["jpeg_quality"])
            return small

        lq, _, _ = D.random_down_up(lq, p["down_scale"],
                                    cfg.downsample_range, "bilinear",
                                    mid_fn=mid)
        lq = torch.clamp(lq, 0.0, 1.0)

        if cfg.color_jitter_prob is not None:
            lq = torch.where(p["jitter_gate"],
                             D.color_jitter(lq, p["jitter"]), lq)
        if cfg.gray_prob:
            lq = D.random_grayscale(lq, p["gray"])
            if cfg.gt_gray:
                gt = D.random_grayscale(gt, p["gray"])
        if cfg.color_jitter_pt_prob is not None:
            lq = torch.where(p["jitter_pt_gate"],
                             D.color_jitter_pt(lq, p["jitter_pt"]), lq)

        lq = torch.clamp(torch.round(lq * 255.0), 0, 255) / 255.0
        mean = D._vec(cfg.mean, gt)
        std = D._vec(cfg.std, gt)
        return (lq - mean) / std, (gt - mean) / std

    def __call__(self, generator: torch.Generator, gt: torch.Tensor):
        n, h, w, c = gt.shape
        return self.apply(gt, self.sample(generator, n, h, w, c))


def make_ffhq_degradation(cfg: FFHQDegradationConfig) -> FFHQDegradation:
    return FFHQDegradation(cfg)
