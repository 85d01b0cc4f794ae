"""Crop large images into overlapping sub-images for SR training (the
DIV2K `*_sub` folders every zoo train config reads).

Counterpart of `scripts/data_preparation/extract_subimages.py`, on the
host, following BasicSR's script where JAX's departs from it:

* DIV2K's LR suffix is stripped from the name (`0001x4.png` →
  `0001_s001.png`), so a GT sub-image and its LR partner share a name and
  pair under `filename_tmpl: '{}'`, as every zoo config pairs them. JAX's
  script keeps the suffix (`0001x4_s001.png`), and its paired dataset then
  looks for an LR file that was never written.
* A last crop at `h − crop_size` (and `w − crop_size`) is added when the
  strided crops leave more than `thresh_size` pixels uncovered, so the
  whole image is used; JAX's script drops the tail.

    python -m image_restoration_tpu_torch.scripts.extract_subimages \\
        --input DIV2K_train_HR --output DIV2K_train_HR_sub \\
        --crop_size 480 --step 240 [--thresh_size 0] [--n_thread 8]

BasicSR's DIV2K settings: HR 480/240, X2 240/120, X3 160/80, X4 120/60.
The output folder must not exist yet.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np

from ..utils.misc import scandir


def crop_starts(length: int, crop_size: int, step: int,
                thresh_size: int = 0) -> np.ndarray:
    """Crop origins along one axis: every `step` while a crop fits, then
    `length − crop_size` when more than `thresh_size` pixels remain."""
    starts = np.arange(0, length - crop_size + 1, step)
    if length - (starts[-1] + crop_size) > thresh_size:
        starts = np.append(starts, length - crop_size)
    return starts


def sub_image_stem(path: str) -> str:
    """The stem a sub-image's name starts with: DIV2K's x2/x3/x4/x8
    suffixes removed."""
    stem = osp.splitext(osp.basename(path))[0]
    for s in ("x2", "x3", "x4", "x8"):
        stem = stem.replace(s, "")
    return stem


def crop_one(path: str, save_folder: str, crop_size: int, step: int,
             thresh_size: int = 0, compression_level: int = 3) -> int:
    """Write `{stem}_s{index:03d}{ext}` for every crop of one image, row by
    row; returns the count."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    h, w = img.shape[:2]
    stem, ext = sub_image_stem(path), osp.splitext(path)[1]
    index = 0
    for y in crop_starts(h, crop_size, step, thresh_size):
        for x in crop_starts(w, crop_size, step, thresh_size):
            index += 1
            crop = np.ascontiguousarray(img[y:y + crop_size,
                                            x:x + crop_size, ...])
            cv2.imwrite(osp.join(save_folder, f"{stem}_s{index:03d}{ext}"),
                        crop, [cv2.IMWRITE_PNG_COMPRESSION,
                               compression_level])
    return index


def extract_subimages(input_folder: str, save_folder: str, crop_size: int,
                      step: int, thresh_size: int = 0, n_thread: int = 8,
                      compression_level: int = 3) -> int:
    """Crop every image of `input_folder` into the new `save_folder` on
    `n_thread` threads; returns the count of sub-images."""
    if osp.exists(save_folder):
        raise FileExistsError(f"folder {save_folder} already exists")
    os.makedirs(save_folder)
    paths = sorted(scandir(input_folder, suffix=("png", "jpg", "jpeg",
                                                 "bmp"), full_path=True))
    with ThreadPoolExecutor(max(1, n_thread)) as pool:
        counts = pool.map(lambda p: crop_one(p, save_folder, crop_size, step,
                                             thresh_size, compression_level),
                          paths)
        return sum(counts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--crop_size", type=int, default=480)
    p.add_argument("--step", type=int, default=240)
    p.add_argument("--thresh_size", type=int, default=0)
    p.add_argument("--n_thread", type=int, default=8)
    p.add_argument("--compression_level", type=int, default=3)
    args = p.parse_args(argv)
    n = extract_subimages(args.input, args.output, args.crop_size,
                          args.step, args.thresh_size, args.n_thread,
                          args.compression_level)
    print(f"wrote {n} sub-images to {args.output}")
    return n


if __name__ == "__main__":
    main()
