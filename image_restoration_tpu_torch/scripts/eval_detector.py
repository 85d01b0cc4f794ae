"""Detector evaluation CLI: per-image detection `.txt` files (name, count,
then `x y w h confidence` lines) and, optionally, the images with their
boxes and landmark dots drawn.

Port of the repo-root `scripts/eval_detector.py:25-105` (parity with
Plate_Detect/Retina-License-Plate/test.py:69-231), through the port's
`PlateDetector.detect_image`. Coordinates are in the original image's
pixels, as JAX writes them.

    python -m image_restoration_tpu_torch.scripts.eval_detector \\
        -m weights/Resnet18_final.pth --dataset_folder images/ \\
        [--save_folder plate_txt/] [--save_image] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import cv2
import numpy as np

from ..detect.engine import PlateDetector
from ..utils.misc import scandir

_COLORS = [(0, 200, 200), (0, 255, 255), (255, 0, 255), (0, 255, 0),
           (255, 0, 0)]


def main(argv=None):
    """Run the CLI; returns the names of the images written as `.txt`."""
    p = argparse.ArgumentParser(description="RetinaFace plate eval")
    p.add_argument("-m", "--trained_model", default=None,
                   help="reference-layout .pth (random weights without)")
    p.add_argument("--network", default="Resnet18",
                   choices=("Resnet18", "Resnet50", "mobilenet0.25",
                            "MobilenetV3"))
    p.add_argument("--dataset_folder", required=True)
    p.add_argument("--testset_list", default=None,
                   help="optional txt listing image names; defaults to "
                        "scanning --dataset_folder")
    p.add_argument("--confidence_threshold", type=float, default=0.02)
    p.add_argument("--nms_threshold", type=float, default=0.4)
    p.add_argument("--save_folder", default="./plate_txt/")
    p.add_argument("--save_image", action="store_true")
    p.add_argument("--results_folder", default="./results/")
    p.add_argument("--vis_thres", type=float, default=0.5)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    det = PlateDetector(backbone=args.network, ckpt_path=args.trained_model,
                        score_threshold=args.confidence_threshold,
                        iou_threshold=args.nms_threshold, device=args.device)

    if args.testset_list:
        with open(args.testset_list) as fr:
            names = fr.read().split()
    else:
        names = sorted(scandir(args.dataset_folder,
                               suffix=("png", "jpg", "jpeg", "bmp")))
    os.makedirs(args.save_folder, exist_ok=True)
    if args.save_image:
        os.makedirs(args.results_folder, exist_ok=True)

    written = []
    t_forward = 0.0
    for i, name in enumerate(names):
        img_raw = cv2.imread(osp.join(args.dataset_folder, name),
                             cv2.IMREAD_COLOR)
        if img_raw is None:
            print(f"skip unreadable {name}")
            continue
        t0 = time.perf_counter()
        boxes, scores, landms, valid = det.detect_image(img_raw)
        t_forward += time.perf_counter() - t0

        keep = valid.astype(bool)
        dets = np.concatenate(
            [boxes[keep], scores[keep, None], landms[keep]], axis=1)

        txt_path = osp.join(args.save_folder, osp.splitext(name)[0] + ".txt")
        os.makedirs(osp.dirname(txt_path) or ".", exist_ok=True)
        with open(txt_path, "w") as fd:
            fd.write(osp.splitext(osp.basename(name))[0] + "\n")
            fd.write(f"{len(dets)}\n")
            for b in dets:
                x, y = int(b[0]), int(b[1])
                w, h = int(b[2]) - int(b[0]), int(b[3]) - int(b[1])
                fd.write(f"{x} {y} {w} {h} {b[4]} \n")
        written.append(name)
        print(f"im_detect: {i + 1}/{len(names)} "
              f"avg_time: {t_forward / (i + 1):.4f}s")

        if args.save_image:
            img = img_raw.copy()
            for b in dets:
                if b[4] < args.vis_thres:
                    continue
                bi = list(map(int, b))
                cv2.rectangle(img, (bi[0], bi[1]), (bi[2], bi[3]),
                              (0, 0, 255), 2)
                cv2.putText(img, f"{b[4]:.4f}", (bi[0], bi[1] + 12),
                            cv2.FONT_HERSHEY_DUPLEX, 0.5, (255, 255, 255))
                for j, color in enumerate(_COLORS):
                    cv2.circle(img, (bi[5 + 2 * j], bi[6 + 2 * j]), 1,
                               color, 4)
            cv2.imwrite(osp.join(args.results_folder, f"{i}.jpg"), img)
    return written


if __name__ == "__main__":
    main()
