"""NIQE of every image in a folder, on the host.

Port of `scripts/metrics/calculate_niqe_folder.py`: numpy on the host, as
in JAX (the metric has no device part, so the CLI takes no `--device`).

    python -m image_restoration_tpu_torch.scripts.calculate_niqe_folder \\
        --input out/ [--crop_border 0] [--params_path niqe_pris_params.npz]
"""

from __future__ import annotations

import argparse
import os.path as osp

import cv2
import numpy as np

from ..metrics import calculate_niqe
from ..utils.misc import scandir


def main(argv=None) -> float:
    """Run the CLI; returns the mean NIQE."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--crop_border", type=int, default=0)
    p.add_argument("--params_path", default=None)
    args = p.parse_args(argv)
    vals = []
    for rel in sorted(scandir(args.input, suffix=("png", "jpg", "jpeg"))):
        img = cv2.imread(osp.join(args.input, rel)).astype(np.float32)
        v = calculate_niqe(img, args.crop_border,
                           params_path=args.params_path)
        vals.append(v)
        print(f"{rel}: NIQE {v:.4f}")
    mean = float(np.mean(vals))
    print(f"Average NIQE {mean:.4f}")
    return mean


if __name__ == "__main__":
    main()
