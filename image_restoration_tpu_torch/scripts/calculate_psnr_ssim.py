"""PSNR and SSIM of a folder of restored images against its GT folder.

Port of `scripts/metrics/calculate_psnr_ssim.py`: each GT image is paired
with `<name><suffix><ext>` in `--restored` (else the same name), and
scored in numpy float64 on the host, as in JAX (no device part, so no
`--device`).

    python -m image_restoration_tpu_torch.scripts.calculate_psnr_ssim \\
        --gt GT/ --restored out/ [--crop_border 4] [--suffix _out] \\
        [--test_y_channel]
"""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..metrics import calculate_psnr, calculate_ssim
from ..utils.misc import scandir


def main(argv=None):
    """Run the CLI; returns (mean PSNR, mean SSIM)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gt", required=True)
    p.add_argument("--restored", required=True)
    p.add_argument("--crop_border", type=int, default=4)
    p.add_argument("--suffix", default="")
    p.add_argument("--test_y_channel", action="store_true")
    args = p.parse_args(argv)

    psnrs, ssims = [], []
    for rel in sorted(scandir(args.gt, suffix=("png", "jpg", "jpeg"))):
        gt = cv2.imread(osp.join(args.gt, rel)).astype(np.float64)
        name, ext = osp.splitext(rel)
        rpath = osp.join(args.restored, name + args.suffix + ext)
        if not osp.exists(rpath):
            rpath = osp.join(args.restored, rel)
        restored = cv2.imread(rpath).astype(np.float64)
        psnr = calculate_psnr(gt, restored, args.crop_border,
                              test_y_channel=args.test_y_channel)
        ssim = calculate_ssim(gt, restored, args.crop_border,
                              test_y_channel=args.test_y_channel)
        psnrs.append(psnr)
        ssims.append(ssim)
        print(f"{rel}: PSNR {psnr:.4f} dB  SSIM {ssim:.4f}")
    means = float(np.mean(psnrs)), float(np.mean(ssims))
    print(f"Average PSNR {means[0]:.4f} dB  SSIM {means[1]:.4f}")
    return means


if __name__ == "__main__":
    main()
