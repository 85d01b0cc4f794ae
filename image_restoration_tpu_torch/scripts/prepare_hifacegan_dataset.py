"""HiFaceGAN training pairs: each 512² GT face degraded by one of six
templates, or by their composition, on the host in cv2/numpy.

Port of `scripts/data_preparation/prepare_hifacegan_dataset.py` (BasicSR's
script wraps imgaug; JAX's, which this follows draw for draw, re-implements
the six templates):

  sr4x    — ×4 area downsample, cubic upsample to 512²
  sr4x8x  — random ×4..×8 area downsample, cubic upsample to 512²
  denoise — additive Gaussian, Laplace or signed Poisson noise per channel
  deblur  — motion blur (k in [10, 20], a random angle) or Gaussian blur
            (σ in [3, 8])
  jpeg    — JPEG at quality 100 − c, c in [50, 85]
  16x     — a 16×16 mosaic (block means)
  full    — sr4x8x, denoise, deblur and jpeg in turn

    python -m image_restoration_tpu_torch.scripts.prepare_hifacegan_dataset \\
        --gt_folder FFHQ_512 --save_folder FFHQ_512_sr4x --deg_type sr4x \\
        [--seed 0]

All draws come from one `numpy.random.default_rng(seed)`, image by image
in sorted order.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import cv2
import numpy as np

from ..utils.misc import scandir


def mosaic_16x(x, rng):
    h, w = x.shape[:2]
    out = x.astype(np.float64)
    for i in range((h + 15) // 16):
        for j in range((w + 15) // 16):
            block = out[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16]
            block[:] = block.mean(axis=(0, 1))
    return out.astype(np.uint8)


def sr4x(x, rng):
    h, w = x.shape[:2]
    small = cv2.resize(x, (max(w // 4, 1), max(h // 4, 1)),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (512, 512), interpolation=cv2.INTER_CUBIC)


def sr4x8x(x, rng):
    h, w = x.shape[:2]
    f = rng.uniform(0.125, 0.25)
    small = cv2.resize(x, (max(int(w * f), 1), max(int(h * f), 1)),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (512, 512), interpolation=cv2.INTER_CUBIC)


def denoise_src(x, rng):
    kind = rng.integers(0, 3)
    xf = x.astype(np.float64)
    if kind == 0:
        xf = xf + rng.normal(0, rng.uniform(20, 40, 3), x.shape)
    elif kind == 1:
        xf = xf + rng.laplace(0, rng.uniform(20, 40, 3), x.shape)
    else:
        lam = rng.uniform(15, 30, 3)
        xf = xf + rng.poisson(lam, x.shape) * rng.choice([-1, 1], x.shape)
    return np.clip(xf, 0, 255).astype(np.uint8)


def deblur_src(x, rng):
    if rng.integers(0, 2) == 0:
        k = int(rng.integers(10, 21))
        kern = np.zeros((k, k), np.float32)
        kern[k // 2, :] = 1.0
        m = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5),
                                    rng.uniform(0, 360), 1.0)
        kern = cv2.warpAffine(kern, m, (k, k))
        kern /= max(kern.sum(), 1e-8)
        return cv2.filter2D(x, -1, kern)
    return cv2.GaussianBlur(x, (0, 0), rng.uniform(3.0, 8.0))


def jpeg_src(x, rng):
    quality = int(100 - rng.uniform(50, 85))
    _, buf = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, quality])
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


TEMPLATES = {
    "sr4x": [sr4x],
    "sr4x8x": [sr4x8x],
    "denoise": [denoise_src],
    "deblur": [deblur_src],
    "jpeg": [jpeg_src],
    "16x": [mosaic_16x],
    "full": [sr4x8x, denoise_src, deblur_src, jpeg_src],
}


def degrade(img: np.ndarray, deg_type: str, rng) -> np.ndarray:
    """One BGR uint8 image through the template `deg_type`."""
    for fn in TEMPLATES[deg_type]:
        img = fn(img, rng)
    return img


def prepare(gt_folder: str, save_folder: str, deg_type: str = "sr4x",
            seed: int = 0) -> int:
    """Degrade every image of `gt_folder` into `save_folder` under the same
    name; returns the count written."""
    rng = np.random.default_rng(seed)
    os.makedirs(save_folder, exist_ok=True)
    names = sorted(scandir(gt_folder, suffix=("png", "jpg", "jpeg")))
    done = 0
    for i, name in enumerate(names):
        img = cv2.imread(osp.join(gt_folder, name), cv2.IMREAD_COLOR)
        if img is None:
            continue
        cv2.imwrite(osp.join(save_folder, name), degrade(img, deg_type, rng))
        done += 1
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(names)}")
    print(f"done: {done} images -> {save_folder}")
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gt_folder", required=True,
                   help="512² GT images (e.g. FFHQ_512)")
    p.add_argument("--save_folder", required=True)
    p.add_argument("--deg_type", default="sr4x", choices=sorted(TEMPLATES))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return prepare(args.gt_folder, args.save_folder, args.deg_type,
                   args.seed)


if __name__ == "__main__":
    main()
