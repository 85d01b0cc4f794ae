"""Offline batch CLI for the full product pipeline on the GPU.

Port of the repo-root `scripts/run_pipeline.py`: detect → crop/mask/pad →
restore plate + car → perspective paste-back (the body of
`/Vehicle_Resolution_GFPGAN/`) over a glob of images, through
`PlatePipeline.process_batch` (detector at bs = chunk, one 2N restore per
chunk when plate and car share a restorer, host stages thread-parallel).

    python -m image_restoration_tpu_torch.scripts.run_pipeline \\
        --input 'test_images/*.jpg' --output out/ [--chunk 8] [--workers 4]
        [--bf16] [--device-geometry] [--detector-ckpt D] [--plate-ckpt P]
        [--car-ckpt C] [--save montage,pasted] [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import cv2

_SAVEABLE = ("montage", "pasted", "plate_restored", "car_restored",
             "crop", "crop_padded", "transform", "input")


def main(argv=None, pipeline=None):
    p = argparse.ArgumentParser(description="batch product pipeline")
    p.add_argument("--input", required=True, help="image file or glob")
    p.add_argument("--output", default="pipeline_out")
    p.add_argument("--chunk", type=int, default=8,
                   help="images per device call")
    p.add_argument("--workers", type=int, default=4,
                   help="host OpenCV threads")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device-geometry", action="store_true",
                   help="crop/mask/warp/paste/montage on the device")
    p.add_argument("--detector-ckpt", default=None)
    p.add_argument("--plate-ckpt", default=None)
    p.add_argument("--car-ckpt", default=None)
    p.add_argument("--device", default=None, help="torch device (cuda)")
    p.add_argument("--seed", type=int, default=0,
                   help="random weights' seed where no checkpoint is given")
    p.add_argument("--save", default="montage,pasted",
                   help=f"comma-set of outputs to write, from {_SAVEABLE}")
    args = p.parse_args(argv)

    keys = [k.strip() for k in args.save.split(",") if k.strip()]
    bad = [k for k in keys if k not in _SAVEABLE]
    if bad:
        p.error(f"--save {bad} not in {_SAVEABLE}")

    paths = sorted(glob.glob(args.input))
    if not paths:
        raise FileNotFoundError(args.input)

    if pipeline is None:
        import torch
        from ..serve.pipeline import PlatePipeline
        pipeline = PlatePipeline(
            detector_ckpt=args.detector_ckpt, plate_ckpt=args.plate_ckpt,
            car_ckpt=args.car_ckpt,
            dtype=torch.bfloat16 if args.bf16 else None,
            device_geometry=args.device_geometry, device=args.device,
            seed=args.seed)

    imgs = [cv2.imread(pth) for pth in paths]
    missing = [pth for pth, im in zip(paths, imgs) if im is None]
    if missing:
        raise FileNotFoundError(f"unreadable image(s): {missing[:5]}")

    os.makedirs(args.output, exist_ok=True)
    t0 = time.time()
    results = pipeline.process_batch(imgs, chunk_size=args.chunk,
                                     host_workers=args.workers)
    wall = time.time() - t0

    detected = 0
    for pth, res in zip(paths, results):
        name = os.path.splitext(os.path.basename(pth))[0]
        detected += bool(res["detected"])
        for k in keys:
            cv2.imwrite(os.path.join(args.output, f"{name}_{k}.png"),
                        res[k])
    print(f"{len(paths)} images in {wall:.2f}s "
          f"({wall / len(paths) * 1e3:.1f} ms/img incl. first calls), "
          f"{detected} plates detected -> {args.output}", flush=True)
    return results


if __name__ == "__main__":
    main()
