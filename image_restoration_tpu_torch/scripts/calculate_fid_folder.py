"""FID between a folder of images and reference statistics or a second
folder.

Port of `scripts/metrics/calculate_fid_folder.py`: each image (png, jpg,
jpeg; sorted) is read as RGB in [0, 1] and resized to 299² on the device
with the port's `ops/resize.resize` (the cv2 bilinear matrix; JAX calls
`cv2.resize` on the host), in batches of 8; the features' mean and
covariance are scored against `--fid_stats` (an `.npz` with `mean` and
`cov`) or against `--folder2`, and `--save_stats_to` writes them.

    python -m image_restoration_tpu_torch.scripts.calculate_fid_folder \\
        --folder results/ --fid_stats inception_FFHQ_256.npz \\
        [--save_stats_to x.npz] [--inception_weights pt_inception.pth] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse

import cv2
import numpy as np
import torch

from ..metrics.fid import (calculate_fid, extract_inception_features,
                           load_patched_inception_v3)
from ..ops.resize import resize
from ..utils.device import resolve_device
from ..utils.misc import scandir

BATCH = 8


def folder_batches(folder: str, device, batch_size: int = BATCH,
                   size: int = 299):
    """Batches of the folder's images, RGB [0, 1], each resized to `size`²
    on `device` (NHWC)."""
    paths = sorted(scandir(folder, suffix=("png", "jpg", "jpeg"),
                           full_path=True))
    if not paths:
        raise FileNotFoundError(f"no png/jpg/jpeg image in {folder}")
    for start in range(0, len(paths), batch_size):
        imgs = []
        for path in paths[start:start + batch_size]:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(f"cannot decode {path}")
            imgs.append(resize(
                torch.from_numpy(img[..., ::-1].copy()).to(device).float()
                / 255.0, (size, size), "bilinear"))
        yield torch.stack(imgs)


def folder_stats(folder: str, extract, device):
    feats = extract_inception_features(folder_batches(folder, device),
                                       extract)
    return feats.mean(0), np.cov(feats, rowvar=False)


def main(argv=None):
    """Run the CLI; returns the FID (None when only saving statistics)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", required=True)
    p.add_argument("--fid_stats", help=".npz with mean/cov of the reference "
                                       "set; omit with --folder2 instead")
    p.add_argument("--folder2")
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception .pth")
    p.add_argument("--save_stats_to", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    extract = load_patched_inception_v3(args.inception_weights, device=dev)
    mu1, sigma1 = folder_stats(args.folder, extract, dev)
    if args.save_stats_to:
        np.savez(args.save_stats_to, mean=mu1, cov=sigma1)
        print(f"saved stats to {args.save_stats_to}")
    if args.fid_stats:
        with np.load(args.fid_stats) as stats:
            mu2, sigma2 = stats["mean"], stats["cov"]
    elif args.folder2:
        mu2, sigma2 = folder_stats(args.folder2, extract, dev)
    else:
        return None
    fid = calculate_fid(mu1, sigma1, mu2, sigma2)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
