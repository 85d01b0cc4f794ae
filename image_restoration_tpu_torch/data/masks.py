"""Random occlusion masks for the OCR dataset.

Port of `image_restoration_tpu/data/masks.py` (the reference's mask suite,
basicsr/data/ocr_degradation_dataset.py:92-183): rectangles, brush-stroke
masks from a host bank, and half masks. As in the port's degradations,
each random op is split into a `sample_*` half that draws the parameters
from a `torch.Generator` and a deterministic apply half that runs batched
on the device, so a test can apply JAX's drawn parameters and a step can
draw once and apply on two devices.

The apply halves compute what JAX computes from the same draws:
`random_rect_masks` :20 (`rect_masks` here, from four uniforms;
`random_rect_masks` draws and applies in one call),
`half_mask` :37 (from the drawn side), `build_irregular_mask_bank` :53
(host numpy, bit-equal to JAX's for a seed) and `apply_random_mask` :83.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def sample_rect_masks(generator: torch.Generator, n: int,
                      num_rects: int = 3) -> Dict[str, torch.Tensor]:
    """The four (n, 1, 1, num_rects) uniforms of `rect_masks`: the top, the
    left, the height and the width fractions, in JAX's order."""
    shape = (n, 1, 1, num_rects)
    return {k: torch.rand(shape, generator=generator,
                          device=generator.device)
            for k in ("y0", "x0", "h", "w")}


def rect_masks(p: Dict[str, torch.Tensor], h: int, w: int,
               min_frac: float = 0.1, max_frac: float = 0.4) -> torch.Tensor:
    """(N, H, W, 1) masks: 1 inside the drawn rectangles."""
    dev = p["y0"].device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    y0 = p["y0"] * h
    x0 = p["x0"] * w
    hh = (min_frac + p["h"] * (max_frac - min_frac)) * h
    ww = (min_frac + p["w"] * (max_frac - min_frac)) * w
    inside = (yy >= y0) & (yy <= y0 + hh) & (xx >= x0) & (xx <= x0 + ww)
    return inside.any(dim=-1, keepdim=True).float()


def random_rect_masks(generator: torch.Generator, shape, num_rects: int = 3,
                      min_frac: float = 0.1,
                      max_frac: float = 0.4) -> torch.Tensor:
    """(N, H, W, 1) masks of `num_rects` random rectangles for an NHWC
    `shape`: JAX `random_rect_masks` (:20-34), drawn and made in one
    call."""
    n, h, w = shape[0], shape[1], shape[2]
    return rect_masks(sample_rect_masks(generator, n, num_rects), h, w,
                      min_frac, max_frac)


def sample_half_mask(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) sides in [0, 4): top, bottom, left, right."""
    return torch.randint(0, 4, (n,), generator=generator,
                         device=generator.device)


def half_mask(side: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W, 1): the drawn half of each image masked."""
    dev = side.device
    yy = torch.arange(h, device=dev)[None, :, None, None]
    xx = torch.arange(w, device=dev)[None, None, :, None]
    s = side.reshape(-1, 1, 1, 1)
    n = s.shape[0]
    masks = torch.stack([(yy < h // 2).expand(n, h, w, 1),
                         (yy >= h // 2).expand(n, h, w, 1),
                         (xx < w // 2).expand(n, h, w, 1),
                         (xx >= w // 2).expand(n, h, w, 1)])
    return torch.gather(masks, 0, s[None].expand(1, n, h, w, 1))[0].float()


def build_irregular_mask_bank(size: int, num: int = 64,
                              seed: int = 0) -> np.ndarray:
    """(num, size, size, 1) brush-stroke masks, drawn on the host from
    `np.random.default_rng(seed)`: the same bank as JAX's."""
    rng = np.random.default_rng(seed)
    bank = []
    for _ in range(num):
        m = np.zeros((size, size), np.float32)
        for _ in range(rng.integers(1, 5)):
            x, y = rng.uniform(0, size, 2)
            angle = rng.uniform(0, 2 * math.pi)
            length_total = rng.uniform(size * 0.5, size * 2)
            width = rng.integers(max(2, size // 32), max(3, size // 8))
            steps = int(length_total / 4) + 1
            for _ in range(steps):
                angle += rng.normal(0, 0.5)
                nx = x + 4 * math.cos(angle)
                ny = y + 4 * math.sin(angle)
                for t in np.linspace(0, 1, 6):
                    cx = int(x + t * (nx - x))
                    cy = int(y + t * (ny - y))
                    y0, y1 = max(0, cy - width), min(size, cy + width)
                    x0, x1 = max(0, cx - width), min(size, cx + width)
                    m[y0:y1, x0:x1] = 1.0
                x, y = nx, ny
                x = min(max(x, 0), size - 1)
                y = min(max(y, 0), size - 1)
        bank.append(m[..., None])
    return np.stack(bank)


def sample_random_mask(generator: torch.Generator, n: int, bank_size: int,
                       mask_prob: float = 0.5,
                       num_rects: int = 3) -> Dict[str, torch.Tensor]:
    """Every random parameter of `apply_random_mask` for n images: whether
    each is masked, its kind (0 rectangles, 1 brush strokes, 2 a half) and
    each kind's own draws."""
    return dict(
        do=torch.rand((n,), generator=generator,
                      device=generator.device) < mask_prob,
        rect=sample_rect_masks(generator, n, num_rects),
        side=sample_half_mask(generator, n),
        idx=torch.randint(0, bank_size, (n,), generator=generator,
                          device=generator.device),
        kind=torch.randint(0, 3, (n,), generator=generator,
                           device=generator.device))


def apply_random_mask(img: torch.Tensor, bank: torch.Tensor,
                      p: Dict[str, torch.Tensor], fill: float = 1.0):
    """(masked image, mask) of an (N, H, W, C) batch: each image the drawn
    `do` selects is occluded by its drawn kind of mask and filled with
    `fill` (white, like the reference's masked plate crops)."""
    n, h, w, _ = img.shape
    rect = rect_masks(p["rect"], h, w)
    half = half_mask(p["side"], h, w)
    irreg = bank[p["idx"]]
    kind = p["kind"].reshape(n, 1, 1, 1)
    mask = torch.where(kind == 0, rect, torch.where(kind == 1, irreg, half))
    mask = mask * p["do"].reshape(n, 1, 1, 1)
    return img * (1 - mask) + fill * mask, mask
