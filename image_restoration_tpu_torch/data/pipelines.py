"""The FFHQ-style degradation pipeline on the device.

Port of `image_restoration_tpu/data/pipelines.py:38-136`
(`FFHQDegradationConfig`, `make_ffhq_degradation`), the production
training chain, in the same order of stages: blur (a mixed kernel per
sample, the pyblur bank, median/bilateral where drawn) → random ↓ →
gaussian noise → JPEG (both at the low resolution) → ↑ back → colour
jitter → gray → pt-style jitter → uint8 round trip → normalize.

`make_ffhq_degradation(cfg)` gives an `FFHQDegradation`: `sample(generator,
n, h, w)` draws every parameter of a batch, `apply(gt, params)` degrades
with them, and calling it does both.

The Real-ESRGAN second-order chain (JAX `:139-300`,
`RealESRGANDegradationConfig`, `_virtual_rescale`,
`make_realesrgan_degradation`) is `RealESRGANDegradation`, split the same
way: two blur stages (the six Gaussian-family kernels, each replaced by a
sinc kernel with `sinc_prob`), a random up/down/keep rescale on a canvas of
the full size, Gaussian or Poisson noise, JPEG, and at the end [bilinear
resize to 1/scale + sinc] and JPEG in a drawn order, then an 8-bit round
trip. Where JAX draws a branch (`bernoulli`, the kernel type), every branch
is computed for the batch and the drawn one taken per sample.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import degradations as D
from .masks import apply_random_mask, sample_random_mask
from .pyblur_bank import build_pyblur_bank
from ..ops.filter2d import filter2d
from ..ops.resize import dynamic_resize_matrix, resize
from ..utils.device import DeviceConstants, const_tensor


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

    def apply(self, gt: torch.Tensor, p: Dict, generator=None):
        """Degrade `gt` with the drawn parameters `p` (every draw is in
        `p`; `generator` is unused, as for the other chains' signature)."""
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


class OCRDegradation:
    """The FFHQ chain, then `masks.apply_random_mask` on its LQ with
    probability `mask_prob`, filled with `fill` (JAX's
    `OCRDegradationDataset.device_pipeline`, data/datasets.py:199-223).
    The brush-stroke bank is host numpy, copied once per device."""

    def __init__(self, base: FFHQDegradation, bank, mask_prob: float = 0.5,
                 fill: float = 1.0):
        self.base = base
        self.bank_np = bank
        self.mask_prob = mask_prob
        self.fill = fill
        self._banks = DeviceConstants(
            lambda dev: torch.as_tensor(bank, device=dev), maxsize=4)

    def sample(self, generator: torch.Generator, n: int, h: int, w: int,
               c: int = 3) -> Dict:
        return {"base": self.base.sample(generator, n, h, w, c),
                "mask": sample_random_mask(generator, n,
                                           self.bank_np.shape[0],
                                           self.mask_prob)}

    def apply(self, gt: torch.Tensor, p: Dict, generator=None):
        lq, gt_n = self.base.apply(gt, p["base"])
        lq, _ = apply_random_mask(lq, self._banks(torch.device(lq.device)),
                                  p["mask"], self.fill)
        return lq, gt_n

    def __call__(self, generator: torch.Generator, gt: torch.Tensor):
        n, h, w, c = gt.shape
        return self.apply(gt, self.sample(generator, n, h, w, c))


# ------------------------------------------------- the Real-ESRGAN chain


@dataclass(frozen=True)
class RealESRGANDegradationConfig:
    """The second-order chain's options, with the JAX dataclass's
    defaults."""
    kernel_list: Tuple[str, ...] = ("iso", "aniso", "generalized_iso",
                                    "generalized_aniso", "plateau_iso",
                                    "plateau_aniso")
    kernel_prob: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    blur_kernel_size: int = 21
    blur_sigma: Tuple[float, float] = (0.2, 3.0)
    betag_range: Tuple[float, float] = (0.5, 4.0)
    betap_range: Tuple[float, float] = (1.0, 2.0)
    sinc_prob: float = 0.1
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)  # up/down/keep
    resize_range: Tuple[float, float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Tuple[float, float] = (1.0, 30.0)
    poisson_scale_range: Tuple[float, float] = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (30.0, 95.0)
    # stage 2
    second_blur_prob: float = 0.8
    kernel_list2: Tuple[str, ...] = ("iso", "aniso", "generalized_iso",
                                     "generalized_aniso", "plateau_iso",
                                     "plateau_aniso")
    kernel_prob2: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    blur_sigma2: Tuple[float, float] = (0.2, 1.5)
    betag_range2: Tuple[float, float] = (0.5, 4.0)
    betap_range2: Tuple[float, float] = (1.0, 2.0)
    sinc_prob2: float = 0.1
    resize_prob2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1.0, 25.0)
    poisson_scale_range2: Tuple[float, float] = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Tuple[float, float] = (30.0, 95.0)
    final_sinc_prob: float = 0.8
    scale: int = 4  # SR scale: lq is (H/scale, W/scale)


def sample_virtual_rescale(generator: torch.Generator, n: int,
                           resize_prob, resize_range) -> Dict:
    """The mode (0 up, 1 down, 2 keep) by `resize_prob` and a scale in
    `resize_range`, per sample."""
    probs = const_tensor(tuple(map(float, resize_prob)), torch.float32,
                         generator.device)
    return dict(mode=torch.multinomial(probs, n, replacement=True,
                                       generator=generator),
                scale=D._uniform(generator, (n,), *resize_range))


def virtual_rescale(img: torch.Tensor, params: Dict,
                    interp: str = "bilinear") -> torch.Tensor:
    """JAX's `_virtual_rescale`: the drawn rescale as a down-up round trip
    on a canvas of the full size. Only a true downscale (mode 1, scale < 1)
    loses information; up and keep are identities of the round trip."""
    n, h, w, c = img.shape
    eff = torch.where(params["mode"] == 1,
                      torch.clamp(params["scale"], max=1.0),
                      torch.ones_like(params["scale"]))
    down_factor = 1.0 / torch.clamp(eff, min=1e-3)
    vh = torch.round(h / down_factor).to(torch.int32)
    vw = torch.round(w / down_factor).to(torch.int32)

    def mats(v, length):
        down = dynamic_resize_matrix(
            length, length, length / torch.clamp(v.float(), min=1.0), v,
            interp)
        up = dynamic_resize_matrix(length, length, v.float() / length,
                                   torch.full_like(v, length), interp)
        return down, up

    dh, uh = mats(vh, h)
    dw, uw = mats(vw, w)
    small = torch.einsum("noh,nhwc->nowc", dh, img)
    small = torch.einsum("npw,nowc->nopc", dw, small)
    out = torch.einsum("noh,nhwc->nowc", uh, small)
    return torch.einsum("npw,nowc->nopc", uw, out)


def _sinc_bank(kernel_size, device):
    return torch.as_tensor(D.sinc_kernel_bank(kernel_size), device=device)


_sinc_banks = DeviceConstants(_sinc_bank, maxsize=4)


class RealESRGANDegradation:
    """degrade(generator, gt) → (lq, gt): lq (N, H/scale, W/scale, C) in
    [0, 1] on 8-bit levels, gt unchanged; gt (N, H, W, C) RGB in [0, 1] on
    the generator's device.

    `sample(generator, n, h, w)` draws every parameter but the Poisson
    counts, which depend on the image: `apply(gt, params, generator)` draws
    those from `generator` where `params` has none and keeps them there, so
    a second `apply` with the same `params` (on another device, through
    `degradations.params_to`) replays the same draw."""

    draws_in_apply = True  # the Poisson counts

    def __init__(self, cfg: RealESRGANDegradationConfig):
        self.cfg = cfg

    def sinc_bank(self, device) -> torch.Tensor:
        return _sinc_banks(self.cfg.blur_kernel_size, torch.device(device))

    # ------------------------------------------------------------- sample

    def _sample_blur(self, g, n, kernel_prob, blur_sigma, betag, betap,
                     sinc_prob) -> Dict:
        k = self.cfg.blur_kernel_size
        return dict(
            kernel=D.sample_mixed_kernel(
                g, n, kernel_prob, kernel_size_range=(k, k),
                sigma_x_range=blur_sigma, sigma_y_range=blur_sigma,
                betag_range=betag, betap_range=betap),
            use_sinc=D._bernoulli(g, sinc_prob, (n,)),
            sinc_idx=D._randint(g, 0, D.SINC_BANK_SIZE, (n,)))

    @staticmethod
    def _sample_noise(g, shape, gauss_prob, noise_range, poisson_range,
                      gray_prob) -> Dict:
        n = shape[0]
        return dict(
            use_gauss=D._bernoulli(g, gauss_prob, (n, 1, 1, 1)),
            gauss=D.sample_gaussian_noise(g, shape, noise_range, gray_prob),
            poisson=D.sample_poisson_noise(g, n, poisson_range, gray_prob))

    def sample(self, generator: torch.Generator, n: int, h: int, w: int,
               c: int = 3) -> Dict:
        """Every random parameter of one batch but the Poisson counts,
        drawn from `generator`."""
        cfg, g = self.cfg, generator
        return dict(
            blur1=self._sample_blur(g, n, cfg.kernel_prob, cfg.blur_sigma,
                                    cfg.betag_range, cfg.betap_range,
                                    cfg.sinc_prob),
            resize1=sample_virtual_rescale(g, n, cfg.resize_prob,
                                           cfg.resize_range),
            noise1=self._sample_noise(g, (n, h, w, c),
                                      cfg.gaussian_noise_prob,
                                      cfg.noise_range,
                                      cfg.poisson_scale_range,
                                      cfg.gray_noise_prob),
            jpeg1=D.sample_jpeg_quality(g, n, cfg.jpeg_range),
            second_blur=D._bernoulli(g, cfg.second_blur_prob, (n, 1, 1, 1)),
            blur2=self._sample_blur(g, n, cfg.kernel_prob2, cfg.blur_sigma2,
                                    cfg.betag_range2, cfg.betap_range2,
                                    cfg.sinc_prob2),
            resize2=sample_virtual_rescale(g, n, cfg.resize_prob2,
                                           cfg.resize_range2),
            noise2=self._sample_noise(g, (n, h, w, c),
                                      cfg.gaussian_noise_prob2,
                                      cfg.noise_range2,
                                      cfg.poisson_scale_range2,
                                      cfg.gray_noise_prob2),
            final_sinc=D._bernoulli(g, cfg.final_sinc_prob, (n,)),
            final_sinc_idx=D._randint(g, 0, D.SINC_BANK_SIZE, (n,)),
            jpeg2=D.sample_jpeg_quality(g, n, cfg.jpeg_range2),
            resize_first=D._bernoulli(g, 0.5, (n, 1, 1, 1)))

    # -------------------------------------------------------------- apply

    def blur_stage(self, img: torch.Tensor, p: Dict,
                   kernel_list) -> torch.Tensor:
        """Mixed kernels of the drawn types, each replaced by its drawn sinc
        kernel where `use_sinc`."""
        k = self.cfg.blur_kernel_size
        kernels = D.mixed_kernel(p["kernel"], kernel_list, k)
        sinc = self.sinc_bank(img.device)[p["sinc_idx"]]
        kernels = torch.where(p["use_sinc"][:, None, None], sinc, kernels)
        return filter2d(img, kernels)

    @staticmethod
    def noise_stage(img: torch.Tensor, p: Dict,
                    generator: Optional[torch.Generator] = None):
        """Gaussian noise where `use_gauss`, Poisson elsewhere (both are
        computed for the batch). The Poisson counts come from `p` or are
        drawn from `generator` and kept in `p`."""
        g = D.add_gaussian_noise(img, p["gauss"])
        pois = p["poisson"]
        if "counts" not in pois:
            src = torch.where(pois["gray"], img.mean(dim=-1, keepdim=True)
                              .expand(img.shape), img)
            pois["counts"] = torch.poisson(
                torch.clamp(src, 0.0, 1.0) * 256.0, generator=generator)
        pz = D.add_poisson_noise(img, pois, counts=pois["counts"])
        return torch.where(p["use_gauss"], g, pz)

    def final_stage(self, img: torch.Tensor, p: Dict) -> torch.Tensor:
        """[bilinear resize to 1/scale + sinc (or the identity)] and JPEG,
        in the drawn order, then the 8-bit round trip."""
        cfg = self.cfg
        n, h, w, c = img.shape
        out_hw = (h // cfg.scale, w // cfg.scale)
        k = cfg.blur_kernel_size
        delta = D._one_hot(k, k // 2, img.device)
        ident = delta[:, None] * delta[None, :]
        fk = torch.where(p["final_sinc"][:, None, None],
                         self.sinc_bank(img.device)[p["final_sinc_idx"]],
                         ident)
        path_a = D.add_jpeg_compression(
            filter2d(resize(img, out_hw, "bilinear"), fk), p["jpeg2"])
        path_b = filter2d(resize(D.add_jpeg_compression(img, p["jpeg2"]),
                                 out_hw, "bilinear"), fk)
        lq = torch.where(p["resize_first"], path_a, path_b)
        return torch.clamp(torch.round(lq * 255.0), 0, 255) / 255.0

    def apply(self, gt: torch.Tensor, p: Dict,
              generator: Optional[torch.Generator] = None):
        """Degrade `gt` with the drawn parameters `p` (Poisson counts from
        `generator` where `p` has none)."""
        cfg = self.cfg
        # stage 1
        lq = self.blur_stage(gt, p["blur1"], cfg.kernel_list)
        lq = virtual_rescale(lq, p["resize1"])
        lq = self.noise_stage(lq, p["noise1"], generator)
        lq = D.add_jpeg_compression(lq, p["jpeg1"])
        # stage 2 (where `second_blur`)
        lq2 = self.blur_stage(lq, p["blur2"], cfg.kernel_list2)
        lq = torch.where(p["second_blur"], lq2, lq)
        lq = virtual_rescale(lq, p["resize2"])
        lq = self.noise_stage(lq, p["noise2"], generator)
        return self.final_stage(lq, p), gt

    def __call__(self, generator: torch.Generator, gt: torch.Tensor):
        n, h, w, c = gt.shape
        return self.apply(gt, self.sample(generator, n, h, w, c), generator)


def make_realesrgan_degradation(
        cfg: RealESRGANDegradationConfig) -> RealESRGANDegradation:
    return RealESRGANDegradation(cfg)
