"""Export the plate detector as deployable artifacts.

Port of the repo-root `scripts/export_detector.py`, the counterpart of the
reference's ONNX → TensorRT chain (convert_onnx.py, create_post_process.py,
add_nms_plugin.py, trtexec). It writes

    <out>/detector.pth   the weights in the reference key layout, which
                         `PlateDetector(ckpt_path=…)` and the server's
                         `--detector-ckpt` load (the JAX script writes an
                         orbax directory, which the port does not read)
    <out>/engine.pt2     a torch.export program of the whole detect graph
    <out>/engine.json    (net, prior decode, NMS) at the serving batch

after a round trip of the program against the live detector, and prints
the batch and the input shape:

    python -m image_restoration_tpu_torch.scripts.export_detector \\
        --out det/ [--backbone Resnet18] [--image_size 224] [--batch 4] \\
        [--ckpt retinaface.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..detect.engine import PlateDetector
from ..serve.engine_restorer import export_graph, save_engine

WEIGHTS_FILE = "detector.pth"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backbone", default="Resnet18")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--ckpt", default=None, help="reference .pth to load")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--batch", type=int, default=4,
                   help="engine batch size (ref TRT profile 1-4)")
    p.add_argument("--seed", type=int, default=0,
                   help="weights from this seed when no --ckpt is given")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    det = PlateDetector(backbone=args.backbone, image_size=args.image_size,
                        ckpt_path=args.ckpt, device=args.device,
                        seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    pth = os.path.join(args.out, WEIGHTS_FILE)
    torch.save({k: v.cpu() for k, v in det.net.state_dict().items()}, pth)
    print(f"exported weights → {pth}")

    s = args.image_size
    t0 = time.perf_counter()
    x = torch.zeros((args.batch, s, s, 3), device=det.device)
    program = export_graph(det.forward, (x,), [det.net])
    seconds = time.perf_counter() - t0

    # round trip before writing: the program against the live detector on
    # seeded BGR images, every output equal
    imgs = torch.from_numpy((np.random.default_rng(0).random(
        (args.batch, s, s, 3)) * 255).astype(np.float32)).to(det.device)
    with torch.inference_mode():
        got, want = program.module()(imgs), det.forward(imgs)
    for name, g, w in zip(("boxes", "scores", "landms", "valid"), got, want):
        if not torch.equal(g, w):
            raise SystemExit(f"detect graph round trip: {name} differ")
    meta = {"model": "RetinaFace", "backbone": args.backbone,
            "image_size": s, "batch": args.batch,
            "input_shape": [args.batch, s, s, 3], "input_dtype": "float32",
            "score_threshold": det.score_threshold,
            "iou_threshold": det.iou_threshold, "top_k": det.top_k,
            "keep_top_k": det.keep_top_k,
            "platforms": [det.device.type], "device": str(det.device)}
    nbytes = save_engine(args.out, program, meta)
    print(f"exported detect graph: batch={args.batch}, input "
          f"{tuple(x.shape)}, {nbytes / 2 ** 20:.1f} MiB, traced in "
          f"{seconds:.1f} s")


if __name__ == "__main__":
    main()
