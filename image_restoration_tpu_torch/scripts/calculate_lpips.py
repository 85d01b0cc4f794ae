"""LPIPS between a folder of restored images and its GT folder.

Port of `scripts/metrics/calculate_lpips.py`: each GT image `<name><ext>`
is paired with `<name><suffix><ext>` in `--restored`, both taken to RGB in
[-1, 1], and scored by the port's `LPIPS` on the device; an unreadable
pair is reported and skipped. `--lpips_weights` (an lpips `vgg.pth`, the
lin layers) and `--vgg_weights` (a torchvision vgg16 `state_dict`) give
calibrated values.

    python -m image_restoration_tpu_torch.scripts.calculate_lpips \\
        --gt GT/ --restored out/ [--suffix _out] [--lpips_weights vgg.pth] \\
        [--vgg_weights vgg16.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import cv2
import numpy as np
import torch

from ..metrics.lpips import LPIPS
from ..utils.device import resolve_device


def _rgb_pm1(img: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(img[..., ::-1].copy()).to(device)
    return x.float() / 255.0 * 2 - 1


def main(argv=None):
    """Run the CLI; returns the mean LPIPS (None when no pair was read)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gt", required=True, help="folder of GT images")
    p.add_argument("--restored", required=True,
                   help="folder of restored images")
    p.add_argument("--suffix", default="",
                   help="suffix appended to restored basenames")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--vgg_weights", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    fn = LPIPS(lpips_weights_path=args.lpips_weights,
               vgg_weights_path=args.vgg_weights).to(dev)
    scores = []
    for i, gt_path in enumerate(sorted(glob.glob(osp.join(args.gt, "*")))):
        base, ext = osp.splitext(osp.basename(gt_path))
        r_path = osp.join(args.restored, base + args.suffix + ext)
        gt = cv2.imread(gt_path, cv2.IMREAD_COLOR)
        restored = cv2.imread(r_path, cv2.IMREAD_COLOR)
        if gt is None or restored is None:
            print(f"skip {base}: unreadable pair")
            continue
        with torch.inference_mode():
            d = float(fn(_rgb_pm1(gt, dev), _rgb_pm1(restored, dev)))
        scores.append(d)
        print(f"{i + 1:6d}: {base:25} \tLPIPS: {d:.6f}")
    if not scores:
        return None
    mean = float(np.mean(scores))
    print(f"Average: LPIPS: {mean:.6f}")
    return mean


if __name__ == "__main__":
    main()
