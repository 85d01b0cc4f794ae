"""Degradation synthesis on the device, a batch at a time.

Port of `image_restoration_tpu/data/degradations.py`. Every random
degradation comes in two halves:

  * `sample_*`: a `torch.Generator` and a batch size in, parameter tensors
    out, drawn on the generator's device;
  * the apply half: images and those parameters in, images out.

So a test hands the same parameters to the JAX function and to the apply
half, and the chip check runs one set of parameters on the card and on the
CPU. The JAX package draws per sample under `jax.vmap` and picks a kernel
type with `lax.switch`; here every listed kernel type is built for the
whole batch and the drawn type index gathers from them, with no loop over
the batch on the host.

Median blur is the JAX package's integer threshold bisection (exact for
8-bit images, so equal to cv2.medianBlur); bilateral blur sums over the
window a row of offsets at a time.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filter2d import filter2d
from ..ops.geometry import homography_from_points, warp_perspective
from ..ops.resize import dynamic_resize_matrix
from ..utils.device import DeviceConstants, const_tensor
from ..utils.diffjpeg import diff_jpeg

# ------------------------------------------------------------ random draws


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _bernoulli(g: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) < p


def _randint(g: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g, device=g.device)


def params_to(params, device):
    """A (nested) dict of drawn parameters with every tensor on `device`:
    draw once, apply on two devices."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device) if torch.is_tensor(params) else params


# ------------------------------------------------------- kernel generators


def _mesh(kernel_size: int, device):
    ax = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1,
                      dtype=torch.float32, device=device)
    xx, yy = torch.meshgrid(ax, ax, indexing="xy")
    return xx, yy


def _inv_sigma(sig_x, sig_y, theta):
    """Inverse of R(θ)·diag(σx², σy²)·R(θ)ᵀ in closed form."""
    c, s = torch.cos(theta), torch.sin(theta)
    sx2, sy2 = sig_x ** 2, sig_y ** 2
    a = c * c / sx2 + s * s / sy2
    b = s * c / sx2 - s * c / sy2
    d = s * s / sx2 + c * c / sy2
    return a, b, d


def _quadratic(kernel_size, sig_x, sig_y, theta, isotropic):
    """xᵀΣ⁻¹x on the (k, k) grid for parameters of shape (...)."""
    sig_x = torch.as_tensor(sig_x, dtype=torch.float32)
    if isotropic:
        sig_y, theta = sig_x, torch.zeros_like(sig_x)
    sig_y = torch.as_tensor(sig_y, dtype=torch.float32, device=sig_x.device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=sig_x.device)
    xx, yy = _mesh(kernel_size, sig_x.device)
    a, b, d = (v[..., None, None] for v in _inv_sigma(sig_x, sig_y, theta))
    return a * xx * xx + 2 * b * xx * yy + d * yy * yy


def _normalized(k: torch.Tensor) -> torch.Tensor:
    return k / k.sum(dim=(-2, -1), keepdim=True)


def bivariate_gaussian(kernel_size: int, sig_x, sig_y, theta,
                       isotropic: bool = True) -> torch.Tensor:
    """(..., k, k) Gaussian kernels for parameters of shape (...)."""
    q = _quadratic(kernel_size, sig_x, sig_y, theta, isotropic)
    return _normalized(torch.exp(-0.5 * q))


def bivariate_generalized_gaussian(kernel_size: int, sig_x, sig_y, theta,
                                   beta, isotropic: bool = True):
    """exp(-0.5 (xᵀΣ⁻¹x)^β)."""
    q = _quadratic(kernel_size, sig_x, sig_y, theta, isotropic)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    return _normalized(torch.exp(-0.5 * torch.pow(
        torch.clamp(q, min=1e-12), beta[..., None, None])))


def bivariate_plateau(kernel_size: int, sig_x, sig_y, theta, beta,
                      isotropic: bool = True) -> torch.Tensor:
    """1/((xᵀΣ⁻¹x)^β + 1)."""
    q = _quadratic(kernel_size, sig_x, sig_y, theta, isotropic)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    return _normalized(1.0 / (torch.pow(torch.clamp(q, min=1e-12),
                                        beta[..., None, None]) + 1.0))


SINC_BANK_SIZE = 64  # the bank's default length, as the JAX package's


def sinc_kernel_bank(kernel_size: int = 21, num: int = SINC_BANK_SIZE,
                     cutoff_range=(np.pi / 3, np.pi)) -> np.ndarray:
    """Host-made bank of circular low-pass (sinc) kernels over a cutoff
    grid."""
    from scipy.special import j1
    bank = []
    for cutoff in np.linspace(cutoff_range[0], cutoff_range[1], num):
        ax = np.arange(kernel_size) - (kernel_size - 1) / 2
        xx, yy = np.meshgrid(ax, ax)
        r = np.sqrt(xx ** 2 + yy ** 2)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = cutoff * j1(cutoff * r) / (2 * np.pi * r)
        k[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
            cutoff ** 2 / (4 * np.pi)
        bank.append(k / k.sum())
    return np.asarray(bank, np.float32)


def _size_mask(kernel_size: torch.Tensor, pad_to: int) -> torch.Tensor:
    """(..., pad_to, pad_to) masks of the centred (size × size) window for
    odd sizes of shape (...)."""
    ax = torch.abs(torch.arange(pad_to, dtype=torch.float32,
                                device=kernel_size.device) - (pad_to - 1) / 2)
    half = (kernel_size.to(torch.float32) - 1) / 2
    m = (ax <= half[..., None] + 1e-6).to(torch.float32)
    return m[..., :, None] * m[..., None, :]


# one-hot (length,) float32 vectors on a device, built once per (length,
# index, device): writing a 1 into a device tensor from the host is a copy
# that waits for the stream
_one_hot = DeviceConstants(
    lambda length, index, device: F.one_hot(
        torch.tensor(index), length).to(torch.float32).to(device), maxsize=8)


def motion_line_kernel(pad_to: int, kernel_size: torch.Tensor,
                       horizontal: torch.Tensor) -> torch.Tensor:
    """Axis-aligned line kernels of the given sizes and orientations."""
    mask = _size_mask(kernel_size, pad_to)
    center = _one_hot(pad_to, (pad_to - 1) // 2, mask.device)
    horiz = center[:, None] * mask
    vert = center[None, :] * mask
    return _normalized(torch.where(horizontal[..., None, None], horiz, vert))


def box_kernel(pad_to: int, kernel_size: torch.Tensor) -> torch.Tensor:
    """Average-blur kernels of the given sizes."""
    return _normalized(_size_mask(kernel_size, pad_to))


def sample_mixed_kernel(generator: torch.Generator, n: int,
                        kernel_prob: Sequence[float],
                        kernel_size_range=(21, 21),
                        sigma_x_range=(0.6, 5.0), sigma_y_range=(0.6, 5.0),
                        rotation_range=(-math.pi, math.pi),
                        betag_range=(0.5, 8.0), betap_range=(0.5, 8.0),
                        bank_size: Optional[int] = None) -> Dict:
    """Draw the parameters of n blur kernels (the sample half of JAX's
    `random_mixed_kernel`, `:141`): the type index by `kernel_prob`, σx,
    σy, θ, the two β, an odd size in `kernel_size_range`, an orientation,
    and a row of the extra bank."""
    probs = const_tensor(tuple(map(float, kernel_prob)), torch.float32,
                         generator.device)
    lo, hi = kernel_size_range
    return dict(
        type_idx=torch.multinomial(probs, n, replacement=True,
                                   generator=generator),
        sig_x=_uniform(generator, (n,), *sigma_x_range),
        sig_y=_uniform(generator, (n,), *sigma_y_range),
        theta=_uniform(generator, (n,), *rotation_range),
        betag=_uniform(generator, (n,), *betag_range),
        betap=_uniform(generator, (n,), *betap_range),
        ksize=lo + 2 * _randint(generator, 0, (hi - lo) // 2 + 1, (n,)),
        horizontal=_bernoulli(generator, 0.5, (n,)),
        bank_idx=_randint(generator, 0, bank_size or 1, (n,)))


def mixed_kernel(params: Dict, kernel_list: Sequence[str], pad_to: int = 21,
                 extra_bank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, pad_to, pad_to) kernels from `sample_mixed_kernel`'s parameters:
    every listed type built for the whole batch, then gathered by the drawn
    type index. 'median' and 'bilateral' give the identity here
    (`apply_nonlinear_blur` applies them); 'pyblur' and 'sinc' are rows of
    `extra_bank`."""
    sx, sy, th = params["sig_x"], params["sig_y"], params["theta"]
    n, dev = sx.shape[0], sx.device
    delta = _one_hot(pad_to, pad_to // 2, dev)
    identity = delta[:, None] * delta[None, :]

    def make(kind):
        if kind == "iso":
            return bivariate_gaussian(pad_to, sx, sy, th, True)
        if kind == "aniso":
            return bivariate_gaussian(pad_to, sx, sy, th, False)
        if kind == "generalized_iso":
            return bivariate_generalized_gaussian(pad_to, sx, sy, th,
                                                  params["betag"], True)
        if kind == "generalized_aniso":
            return bivariate_generalized_gaussian(pad_to, sx, sy, th,
                                                  params["betag"], False)
        if kind == "plateau_iso":
            return bivariate_plateau(pad_to, sx, sy, th, params["betap"],
                                     True)
        if kind == "plateau_aniso":
            return bivariate_plateau(pad_to, sx, sy, th, params["betap"],
                                     False)
        if kind == "motion":
            return motion_line_kernel(pad_to, params["ksize"],
                                      params["horizontal"])
        if kind == "average":
            return box_kernel(pad_to, params["ksize"])
        if kind in ("median", "bilateral"):
            return identity.expand(n, pad_to, pad_to)
        if kind in ("pyblur", "sinc"):
            if extra_bank is None:
                raise ValueError(f"{kind} needs a kernel bank")
            return extra_bank.to(dev)[params["bank_idx"]]
        raise ValueError(f"unknown kernel type {kind}")

    stacked = torch.stack([make(k) for k in kernel_list])  # (T, n, k, k)
    return stacked[params["type_idx"], torch.arange(n, device=dev)]


def random_mixed_kernel(generator: torch.Generator, n: int,
                        kernel_list: Sequence[str],
                        kernel_prob: Sequence[float], pad_to: int = 21,
                        extra_bank: Optional[torch.Tensor] = None, **ranges):
    """Draw and build n kernels. Returns (kernels (n, pad_to, pad_to),
    type_idx (n,))."""
    bank_size = None if extra_bank is None else extra_bank.shape[0]
    params = sample_mixed_kernel(generator, n, kernel_prob,
                                 bank_size=bank_size, **ranges)
    return (mixed_kernel(params, kernel_list, pad_to, extra_bank),
            params["type_idx"])


# -------------------------------------------------------- nonlinear blurs


def _pad_nchw(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N, H, W, C) → edge-padded (N, C, H + 2p, W + 2p)."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")


def median_blur(x: torch.Tensor, ksize: int = 21,
                bits: int = 8) -> torch.Tensor:
    """Median filter by per-pixel threshold bisection on the 8-bit levels
    (equal to cv2.medianBlur for images quantized to 2^bits levels). Each
    of the `bits` rounds counts, for every pixel, the window values at or
    below its current threshold, over the whole k × k window in one pass."""
    p = ksize // 2
    q = torch.round(x * 255.0).to(torch.uint8)
    qp = _pad_nchw(q.to(torch.float32), p).to(torch.int16)
    win = qp.unfold(2, ksize, 1).unfold(3, ksize, 1)  # (N, C, H, W, k, k)
    rank = (ksize * ksize + 1) // 2
    n, h, w, c = x.shape
    lo = torch.zeros((n, c, h, w), dtype=torch.int16, device=x.device)
    hi = torch.full((n, c, h, w), 255, dtype=torch.int16, device=x.device)
    for _ in range(bits):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        cnt = (win <= mid[..., None, None]).sum(dim=(-2, -1))
        le_half = cnt >= rank
        hi = torch.where(le_half, mid, hi)
        lo = torch.where(le_half, lo, mid + 1)
    return (lo.to(x.dtype) / 255.0).permute(0, 2, 3, 1)


def bilateral_blur(x: torch.Tensor, ksize: int = 21, sigma_color=200.0,
                   sigma_space=200.0) -> torch.Tensor:
    """Bilateral filter, cv2.bilateralFilter's weights on [0, 255] values:
    a circular window of radius k//2, colour weight
    exp(-(Σ_c |diff|)² / 2σc²) shared by the channels. `sigma_*` may be
    tensors (a drawn σ)."""
    p = ksize // 2
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    xp = _pad_nchw(x, p)
    ax = tuple(range(-p, ksize - p))
    r2 = const_tensor(tuple(tuple(a * a + b * b for b in ax) for a in ax),
                      torch.float32, x.device)
    sigma_space = torch.as_tensor(sigma_space, dtype=torch.float32,
                                  device=x.device)
    sigma_color = torch.as_tensor(sigma_color, dtype=torch.float32,
                                  device=x.device)
    sw = torch.exp(-r2 / (2 * sigma_space ** 2)) * (r2 <= p * p)
    inv2sc = 1.0 / (2 * sigma_color ** 2)
    num = torch.zeros_like(xc)
    den = torch.zeros((n, 1, h, w), dtype=x.dtype, device=x.device)
    for dy in range(ksize):
        win = xp[:, :, dy:dy + h, :].unfold(3, ksize, 1)  # (N, C, H, W, k)
        diff_l1 = torch.sum(torch.abs(win - xc[..., None]) * 255.0, dim=1,
                            keepdim=True)
        wgt = sw[dy] * torch.exp(-(diff_l1 * diff_l1) * inv2sc)
        num = num + torch.sum(wgt * win, dim=-1)
        den = den + torch.sum(wgt, dim=-1)
    return (num / torch.clamp(den, min=1e-8)).permute(0, 2, 3, 1)


def _slotted_apply(x, is_type, blur_fn, slots):
    """Blur only a fixed-size gathered subset (the samples that drew this
    type first), then scatter back. Exact whenever #drawn <= slots;
    overflow samples keep the linear blur."""
    s = min(slots, x.shape[0])
    order = torch.argsort((~is_type).to(torch.int8), stable=True)
    sel = order[:s]
    sub = x.index_select(0, sel)
    keep = is_type[sel][:, None, None, None]
    return x.index_copy(0, sel, torch.where(keep, blur_fn(sub), sub))


def sample_nonlinear_blur(generator: torch.Generator) -> torch.Tensor:
    """The bilateral σ (colour and space), one per batch, in [150, 250]."""
    return _uniform(generator, (), 150.0, 250.0)


def apply_nonlinear_blur(x: torch.Tensor, kernel_type_idx: torch.Tensor,
                         kernel_list: Sequence[str], sigma=None,
                         ksize: int = 21,
                         slots: Optional[int] = None) -> torch.Tensor:
    """Median or bilateral blur where the drawn type says so, identity
    elsewhere. `sigma` is `sample_nonlinear_blur`'s draw; `slots` caps how
    many batch elements each filter runs on (None: the whole batch)."""
    med_ids = [i for i, k in enumerate(kernel_list) if k == "median"]
    bil_ids = [i for i, k in enumerate(kernel_list) if k == "bilateral"]
    out = x
    if med_ids:
        is_med = kernel_type_idx == med_ids[0]
        if slots is not None:
            out = _slotted_apply(out, is_med,
                                 lambda s: median_blur(s, ksize), slots)
        else:
            out = torch.where(is_med[:, None, None, None],
                              median_blur(x, ksize), out)
    if bil_ids:
        if sigma is None:
            raise ValueError("bilateral blur needs the drawn sigma")
        is_bil = kernel_type_idx == bil_ids[0]
        if slots is not None:
            out = _slotted_apply(
                out, is_bil,
                lambda s: bilateral_blur(s, ksize, sigma, sigma), slots)
        else:
            out = torch.where(is_bil[:, None, None, None],
                              bilateral_blur(x, ksize, sigma, sigma), out)
    return out


# ---------------------------------------------------------------- noises


def sample_gaussian_noise(generator: torch.Generator, shape,
                          sigma_range=(0, 1.0), gray_prob: float = 0.0):
    """σ per sample in sigma_range/255, standard normal draws of `shape`,
    and the per-sample gray gate."""
    n = shape[0]
    return dict(
        sigma=_uniform(generator, (n, 1, 1, 1), *sigma_range) / 255.0,
        normal=torch.randn(shape, generator=generator,
                           device=generator.device),
        gray=_bernoulli(generator, gray_prob, (n, 1, 1, 1)))


def gaussian_noise(params: Dict) -> torch.Tensor:
    """The noise of `sample_gaussian_noise`'s draw (gray: channel mean)."""
    noise = params["normal"] * params["sigma"]
    return torch.where(params["gray"], noise.mean(dim=-1, keepdim=True),
                       noise)


def random_gaussian_noise(generator: torch.Generator, shape,
                          sigma_range=(0, 1.0),
                          gray_prob: float = 0.0) -> torch.Tensor:
    """Noise of `shape` with σ per sample in sigma_range/255, gray (the
    channel mean) w.p. gray_prob: JAX `random_gaussian_noise` (:374-389),
    drawn and made in one call."""
    return gaussian_noise(sample_gaussian_noise(generator, shape,
                                                sigma_range, gray_prob))


def add_gaussian_noise(img: torch.Tensor, params: Dict,
                       clip: bool = True) -> torch.Tensor:
    out = img + gaussian_noise(params).to(img.dtype)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def sample_poisson_noise(generator: torch.Generator, n: int,
                         scale_range=(0.0, 1.0), gray_prob: float = 0.0):
    return dict(scale=_uniform(generator, (n, 1, 1, 1), *scale_range),
                gray=_bernoulli(generator, gray_prob, (n, 1, 1, 1)))


def add_poisson_noise(img: torch.Tensor, params: Dict, counts=None,
                      generator: Optional[torch.Generator] = None,
                      clip: bool = True, vals: float = 256.0):
    """Shot noise at the 2^8 quantization level. The Poisson draw depends
    on the image, so it is made here from `generator`, unless `counts`
    (the draw itself) is given."""
    base = img.mean(dim=-1, keepdim=True)
    src = torch.where(params["gray"], base.expand(img.shape), img)
    lam = torch.clamp(src, 0.0, 1.0) * vals
    if counts is None:
        counts = torch.poisson(lam, generator=generator)
    noise = counts.to(img.dtype) / vals - src
    out = img + noise * params["scale"]
    return torch.clamp(out, 0.0, 1.0) if clip else out


def sample_jpeg_quality(generator: torch.Generator, n: int,
                        quality_range=(30, 100)) -> torch.Tensor:
    return _uniform(generator, (n,), *quality_range)


def add_jpeg_compression(img: torch.Tensor,
                         quality: torch.Tensor) -> torch.Tensor:
    """Per-sample JPEG at the drawn qualities."""
    return torch.clamp(diff_jpeg(img, quality, differentiable=False),
                       0.0, 1.0)


# -------------------------------------------------- resize (random scale)


def sample_down_up_scale(generator: torch.Generator, n: int,
                         scale_range=(4.0, 12.0)) -> torch.Tensor:
    return _uniform(generator, (n,), *scale_range)


def random_down_up(img: torch.Tensor, scale: torch.Tensor,
                   scale_range=(4.0, 12.0), interpolation: str = "bilinear",
                   mid_fn=None):
    """Downsample by the drawn per-sample `scale`, apply `mid_fn(small,
    valid_hw)` at the low resolution, upsample back. The low-resolution
    canvas is static, ceil(size / scale_range[0]); its rows and columns past
    each sample's valid extent are zeroed by the matrices, which are built
    per sample on the device. Returns (out, small, (vh, vw))."""
    n, h, w, c = img.shape
    mid_h = int(math.ceil(h / scale_range[0]))
    mid_w = int(math.ceil(w / scale_range[0]))
    vh = torch.round(h / scale).to(torch.int32)
    vw = torch.round(w / scale).to(torch.int32)

    def down(vout, out_len, in_len):
        return dynamic_resize_matrix(
            out_len, in_len, in_len / torch.clamp(vout.float(), min=1.0),
            vout, interpolation)

    def up(vin, out_len, in_len):
        return dynamic_resize_matrix(
            out_len, in_len, vin.float() / out_len,
            torch.full_like(vin, out_len), interpolation)

    small = torch.einsum("noh,nhwc->nowc", down(vh, mid_h, h), img)
    small = torch.einsum("npw,nowc->nopc", down(vw, mid_w, w), small)
    if mid_fn is not None:
        small = mid_fn(small, (vh, vw))
    out = torch.einsum("noh,nhwc->nowc", up(vh, h, mid_h), small)
    out = torch.einsum("npw,nowc->nopc", up(vw, w, mid_w), out)
    return out, small, (vh, vw)


# ------------------------------------------------------------ color jitter

_GRAY = (0.299, 0.587, 0.114)


def _vec(vals, ref: torch.Tensor) -> torch.Tensor:
    return const_tensor(tuple(vals), ref.dtype, ref.device)


def sample_color_jitter(generator: torch.Generator, n: int,
                        shift: float) -> torch.Tensor:
    """Per-channel shifts (n, 1, 1, 3) in [-shift, shift]."""
    return _uniform(generator, (n, 1, 1, 3), -shift, shift)


def color_jitter(img: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img + jitter, 0.0, 1.0)


def sample_color_jitter_pt(generator: torch.Generator, n: int,
                           brightness=(0.5, 1.5), contrast=(0.5, 1.5),
                           saturation=(0, 1.5), hue=(-0.1, 0.1)) -> Dict:
    """Brightness, contrast and saturation factors and the hue angle
    (radians), each (n, 1, 1, 1)."""
    shape = (n, 1, 1, 1)
    return dict(brightness=_uniform(generator, shape, *brightness),
                contrast=_uniform(generator, shape, *contrast),
                saturation=_uniform(generator, shape, *saturation),
                hue=_uniform(generator, shape, *hue) * 2 * math.pi)


def color_jitter_pt(img: torch.Tensor, params: Dict) -> torch.Tensor:
    """Brightness, contrast, saturation, then hue (a rotation of the YIQ
    chroma plane), in that fixed order."""
    img = torch.clamp(img * params["brightness"], 0, 1)
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = torch.clamp((img - mean) * params["contrast"] + mean, 0, 1)
    gray = torch.mean(img * _vec(_GRAY, img), dim=-1, keepdim=True)
    img = torch.clamp((img - gray) * params["saturation"] + gray, 0, 1)
    y = torch.sum(img * _vec(_GRAY, img), -1, keepdim=True)
    i = torch.sum(img * _vec((0.596, -0.274, -0.322), img), -1, keepdim=True)
    q = torch.sum(img * _vec((0.211, -0.523, 0.312), img), -1, keepdim=True)
    cos, sin = torch.cos(params["hue"]), torch.sin(params["hue"])
    i2 = i * cos - q * sin
    q2 = i * sin + q * cos
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.clamp(torch.cat([r, g, b], dim=-1), 0, 1)


def sample_gate(generator: torch.Generator, n: int,
                prob: float) -> torch.Tensor:
    """A per-sample Bernoulli gate (n, 1, 1, 1)."""
    return _bernoulli(generator, prob, (n, 1, 1, 1))


def random_grayscale(img: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """Gray replicated to 3 channels where the gate `gray` is set."""
    g = torch.sum(img * _vec(_GRAY, img), -1, keepdim=True)
    return torch.where(gray, g.expand(img.shape), img)


# --------------------------------------------------- perspective roundtrip

# corner bands for the three `factor` layouts (rows), corners TL, TR, BL,
# BR, entries (x, y): 0 = [0, dim/down·(scale-1)], 1 = [·(scale-1), ·scale],
# 2 = [·scale, dim]
_PERS_BANDS = ((((0, 0), (2, 0), (0, 2), (2, 2))),
               (((0, 1), (1, 0), (1, 2), (2, 1))),
               (((1, 0), (2, 1), (0, 1), (1, 2))))


def sample_perspective(generator: torch.Generator, n: int,
                       down_choices=(3, 5)) -> Dict:
    """Per sample: the down factor, the corner layout (0-2) and the four
    corners' uniform positions in their bands (n, 4, 2)."""
    choices = const_tensor(tuple(map(float, down_choices)), torch.float32,
                           generator.device)
    return dict(
        down=choices[_randint(generator, 0, len(down_choices), (n,))],
        u=torch.rand((n, 4, 2), generator=generator,
                     device=generator.device),
        factor=_randint(generator, 0, 3, (n,)))


def perspective_roundtrip(img: torch.Tensor, params: Dict) -> torch.Tensor:
    """Warp each image to its drawn quadrilateral and back."""
    n, h, w, c = img.shape
    dev = img.device
    down = params["down"]
    scale = torch.div(down + 1, 2, rounding_mode="floor")
    bands = const_tensor(_PERS_BANDS, torch.int64, dev)[params["factor"]]
    u = params["u"]

    def banded(dim, band_id, uu):
        lo = dim / down * (scale - 1)
        hi = dim / down * scale
        lows = torch.stack([torch.zeros_like(lo), lo, hi], -1)
        highs = torch.stack([lo, hi, torch.full_like(lo, float(dim))], -1)
        lo_b, hi_b = lows.gather(1, band_id), highs.gather(1, band_id)
        return lo_b + uu * (hi_b - lo_b)

    xs = banded(w, bands[..., 0], u[..., 0])
    ys = banded(h, bands[..., 1], u[..., 1])
    pts1 = const_tensor(((0, 0), (w, 0), (0, h), (w, h)), torch.float32,
                        dev).expand(n, 4, 2)
    pts2 = torch.stack([xs, ys], dim=-1)
    m = homography_from_points(pts1, pts2)
    m_inv = homography_from_points(pts2, pts1)
    return warp_perspective(warp_perspective(img, m), m_inv)
