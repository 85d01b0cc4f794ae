"""Meta-info lists of the video and paired datasets.

Port of `scripts/data_preparation/generate_meta_info.py`:

  reds   "<clip> <frames> (<h>,<w>,3)" for REDS's clips 000–269, 100
         frames of 720×1280 each; reds4 the same for the REDS4 test clips
         000, 011, 015 and 020;
  vimeo  "<clip>/<seq> 7 (256,448,3)" for each line of Vimeo-90K's
         sep_trainlist.txt or sep_testlist.txt;
  folder "<name> (<h>,<w>,<c>)" for each image of a GT folder (`--root`;
         the root script's `gen_folder` :44, byte-equal).

With `--root`, reds and reds4 read the clips from a REDS-layout folder
(`<root>/<clip>/<frame>.png`) instead: each clip's frame count and its
first frame's shape (reds4: only the REDS4 clips found there), so a set
cut to fewer or smaller frames gets a list that matches it.

    python -m image_restoration_tpu_torch.scripts.generate_meta_info reds \\
        --out meta_info_REDS_GT.txt [--root datasets/REDS/train_sharp]
    python -m image_restoration_tpu_torch.scripts.generate_meta_info vimeo \\
        --list sep_trainlist.txt --out meta_info_Vimeo90K_train_GT.txt
    python -m image_restoration_tpu_torch.scripts.generate_meta_info folder \\
        --root datasets/DIV2K/GT_sub --out meta_info_DIV2K_GT.txt
"""

from __future__ import annotations

import argparse
import os
from os import path as osp
from typing import Optional

import cv2

REDS4 = ("000", "011", "015", "020")


def reds_lines(root: Optional[str] = None, test_only: bool = False) -> list:
    """The meta-info lines of REDS (or REDS4), canonical or read from
    `root`."""
    if root is None:
        clips = REDS4 if test_only else [f"{i:03d}" for i in range(270)]
        return [f"{c} 100 (720,1280,3)" for c in clips]
    lines = []
    for clip in sorted(os.listdir(root)):
        folder = osp.join(root, clip)
        if not osp.isdir(folder) or (test_only and clip not in REDS4):
            continue
        frames = sorted(f for f in os.listdir(folder)
                        if f.lower().endswith(".png"))
        h, w, c = cv2.imread(osp.join(folder, frames[0])).shape
        lines.append(f"{clip} {len(frames)} ({h},{w},{c})")
    return lines


def vimeo_lines(list_path: str) -> list:
    with open(list_path) as f:
        keys = [line.strip() for line in f if line.strip()]
    return [f"{k} 7 (256,448,3)" for k in keys]


def folder_lines(root: str,
                 suffix=("png", "jpg", "jpeg", "bmp")) -> list:
    """One line per image file of `root`, sorted by name, with its shape
    as cv2 reads it (gray images count one channel)."""
    lines = []
    for name in sorted(n for n in os.listdir(root)
                       if n.lower().endswith(tuple(suffix))):
        img = cv2.imread(osp.join(root, name))
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        lines.append(f"{name} ({h},{w},{c})")
    return lines


def write_lines(lines, out: str) -> None:
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.writelines(f"{line}\n" for line in lines)
    print(f"{out}: {len(lines)} lines")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=["reds", "reds4", "vimeo", "folder"])
    ap.add_argument("--list", help="sep_trainlist.txt for vimeo")
    ap.add_argument("--root", help="a REDS-layout folder to read (reds, "
                                   "reds4), the image folder (folder)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.kind == "vimeo":
        if not args.list:
            ap.error("--list required for vimeo")
        lines = vimeo_lines(args.list)
    elif args.kind == "folder":
        if not args.root:
            ap.error("--root required for folder")
        lines = folder_lines(args.root)
    else:
        lines = reds_lines(args.root, test_only=args.kind == "reds4")
    write_lines(lines, args.out)
    return lines


if __name__ == "__main__":
    main()
