"""Detector convergence: RetinaFace-R18 trained from random init on
synthetic plate scenes made on the device (`detect/synth.py`), then scored
through the serving engine `PlateDetector` (decode + NMS): the top
detection's IoU against the ground truth, the detection rate and the
landmark error, before and after training.

Port of the repo-root `scripts/bench_detector_convergence.py` with its
`evaluate` and its defaults: Resnet18, 224², batch 24, 1500 iterations, the
×0.1 decay at 70%, 16 held-out scenes. Each batch is drawn and rendered on
the device inside the loop; the losses stay there until the end.

    python -m image_restoration_tpu_torch.scripts.detector_convergence \\
        [--iters 1500] [--bs 24] [--size 224] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.detector_convergence \\
        --tiny      # 64², 60 iterations of batch 8, on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..detect.engine import BGR_MEAN, PlateDetector
from ..detect.synth import make_batch
from ..detect.train import DetectorTrainer


def iou_xyxy(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def evaluate(detector: PlateDetector, trainer: DetectorTrainer, seed: int,
             n: int, size: int) -> dict:
    """Score the trainer's weights through `detector` on n held-out scenes
    drawn from `seed`: mean top-1 IoU (0 where nothing was kept), the share
    of scenes with a kept detection, and the mean landmark error of the
    hits."""
    detector.net.load_state_dict(trainer.net.state_dict())
    gen = torch.Generator(detector.device).manual_seed(seed)
    with torch.no_grad():
        imgs, targets = make_batch(gen, n, size)
    boxes, _, landms, valid = (t.cpu().numpy()
                               for t in detector.detect(imgs))
    targets = targets.cpu().numpy()
    ious, lm_errs, hits = [], [], 0
    for i in range(n):
        if not valid[i, 0]:
            ious.append(0.0)
            continue
        hits += 1
        ious.append(iou_xyxy(boxes[i, 0], targets[i, 0, :4]))
        lm_errs.append(float(np.abs(landms[i, 0] - targets[i, 0, 4:14])
                             .mean()))
    return {"mean_iou": float(np.mean(ious)), "det_rate": hits / n,
            "mean_landmark_err": (float(np.mean(lm_errs)) if lm_errs
                                  else None)}


def log(msg):
    print(msg, flush=True)


def run(iters: int = 1500, bs: int = 24, size: int = 224, eval_n: int = 16,
        chunk: int = 250, device=None) -> dict:
    """Train and score; returns the report (losses, both evals, s/step of
    the chunks after the first)."""
    trainer = DetectorTrainer(backbone="Resnet18", image_size=size,
                              decay_steps=(int(iters * 0.7),),
                              device=device)
    dev = trainer.device
    detector = PlateDetector(backbone="Resnet18", image_size=size,
                             device=dev)
    base = evaluate(detector, trainer, 99, eval_n, size)
    log(f"random-init eval: {base}")

    mean = torch.tensor(BGR_MEAN, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    losses, chunk_s = [], []
    for c0 in range(0, iters, chunk):
        t0 = time.perf_counter()
        for _ in range(min(chunk, iters - c0)):
            with torch.no_grad():
                imgs, tgts = make_batch(gen, bs, size)
            # the engine's preprocess is x − BGR_MEAN: train on the same
            losses.append(trainer.train_step(imgs - mean, tgts)["loss"])
        curve = torch.stack(losses[c0:]).cpu().numpy()   # waits for the card
        chunk_s.append(time.perf_counter() - t0)
        log(f"iters {c0}-{c0 + len(curve)}: loss {curve[0]:.3f} → "
            f"{curve[-1]:.3f} ({chunk_s[-1]:.1f}s)")
    curve = torch.stack(losses).cpu().numpy()
    final = evaluate(detector, trainer, 99, eval_n, size)
    log(f"trained eval ({iters} iters): {final}")
    later = chunk_s[1:]
    return {
        "backbone": "Resnet18", "image_size": size, "iters": iters,
        "bs": bs, "device": str(dev),
        "loss_first10": [float(v) for v in curve[:10]],
        "loss_curve_every50": [float(v) for v in curve[::50]],
        "loss_final": float(curve[-1]),
        "eval_random_init": base, "eval_trained": final,
        "s_per_step_after_first_chunk": (
            sum(later) / (iters - chunk) if later else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--bs", type=int, default=24,
                    help="the reference budget (cfg batch_size)")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--chunk", type=int, default=250,
                    help="iterations between host reads of the losses")
    ap.add_argument("--eval-n", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="write the report as JSON")
    ap.add_argument("--tiny", action="store_true",
                    help="64², 60 iterations of batch 8, on the CPU (flags "
                         "given explicitly still apply)")
    args = ap.parse_args(argv)
    if args.tiny:
        tiny = dict(iters=60, bs=8, size=64, chunk=20, eval_n=8,
                    device="cpu")
        for k, v in tiny.items():
            if getattr(args, k) == ap.get_default(k):
                setattr(args, k, v)
    report = run(args.iters, args.bs, args.size, args.eval_n, args.chunk,
                 args.device)
    print(json.dumps({"metric": "detector_convergence_mean_iou",
                      "value": report["eval_trained"]["mean_iou"],
                      "unit": "IoU@top1", "iters": args.iters}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
