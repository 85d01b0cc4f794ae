"""Merge REDS's 30 validation clips into the training folders.

Port of `scripts/data_preparation/regroup_reds_dataset.py`: each clip of
`val_sharp` (and of `val_sharp_bicubic/X4`) is copied into `train_sharp`
(`train_sharp_bicubic/X4`) as clip 240 + its index, so the training sets
hold clips 000–269 and the datasets' `val_partition: official` (240–269)
splits them again by name.

    python -m image_restoration_tpu_torch.scripts.regroup_reds_dataset \\
        --root datasets/REDS
"""

from __future__ import annotations

import argparse
import os
import shutil
from os import path as osp


def regroup_reds_dataset(train_path: str, val_path: str) -> list:
    """Copy every clip folder of `val_path` into `train_path` renamed to
    240 + its index; returns the new clip names."""
    names = []
    for name in sorted(os.listdir(val_path)):
        folder = osp.join(val_path, name)
        if not osp.isdir(folder):
            continue
        dst = osp.join(train_path, f"{int(name) + 240:03d}")
        print(f"{folder} -> {dst}")
        shutil.copytree(folder, dst, dirs_exist_ok=True)
        names.append(osp.basename(dst))
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="datasets/REDS")
    args = ap.parse_args(argv)
    for train, val in (("train_sharp", "val_sharp"),
                       ("train_sharp_bicubic/X4", "val_sharp_bicubic/X4")):
        regroup_reds_dataset(osp.join(args.root, train),
                             osp.join(args.root, val))


if __name__ == "__main__":
    main()
