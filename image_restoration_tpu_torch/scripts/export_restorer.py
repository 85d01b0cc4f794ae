"""Export the ×4 SR tile restorer as a serving engine.

Port of the repo-root `scripts/export_restorer.py`. It builds
SRVGGNetCompact (random weights from `--seed`, or `--pth`), applies the
int8 PTQ with pack-2 weights (or, with `--bf16`, the packed bf16 path;
or, with `--qat-ckpt`, the int8 weights and scales of a quantization-aware
training run's `ckpt_{iter}.pth`),
exports the serving function with `torch.export` at the frozen
(batch, tile + 2·halo, tile + 2·halo, 3) input, checks the round trip
before it writes (the exported program against the live function, the JAX
exporter's ≥ 30 dB gate), and writes

    <out>/engine.pt2    the program, weights inside
    <out>/engine.json   shape, dtype, halo and device metadata

for `serve.engine_restorer.EngineRestorer(<out>)` and the server's
`IRT_SR_ENGINE`:

    python -m image_restoration_tpu_torch.scripts.export_restorer \\
        --out engine_sr/ [--pth realesr.pth | --qat-ckpt ckpt_40000.pth] \\
        [--tile 512] [--halo 8] [--batch 8] [--bf16] [--u8-io] \\
        [--device cuda]

The artifact runs only on the device type it was exported on.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..serve.engine_restorer import export_graph, save_engine
from ..serve.sr_engine import build_graph


def build_engine(num_feat=64, num_conv=32, upscale=4, tile=512, halo=8,
                 batch=8, pth=None, int8=True, calib=None, seed=0,
                 io="bf16", qat_ckpt=None, device=None):
    """Returns (program, meta, serve): the torch.export program of the
    serving graph, its metadata, and the live graph (JAX's
    `build_engine` returns serialized bytes in the program's place)."""
    graph, meta = build_graph(num_feat=num_feat, num_conv=num_conv,
                              upscale=upscale, tile=tile, halo=halo,
                              batch=batch, pth=pth, int8=int8, calib=calib,
                              seed=seed, io=io, qat_ckpt=qat_ckpt,
                              device=device)
    size = tile + 2 * halo
    dt = torch.uint8 if io == "u8" else torch.bfloat16
    x = torch.zeros((batch, size, size, 3), dtype=dt, device=meta["device"])
    return export_graph(graph, (x,)), meta, graph


def round_trip_db(serve, engine, x: torch.Tensor) -> float:
    """Span-normalized PSNR of the artifact's output against the live
    graph's on x."""
    with torch.inference_mode():
        got = engine(x).float().cpu().numpy()
        want = serve(x).float().cpu().numpy()
    mse = float(np.mean((got - want) ** 2))
    span = float(want.max() - want.min()) or 1.0
    return 10 * np.log10(span ** 2 / max(mse, 1e-12))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--pth", default=None, help="torch SRVGG weights")
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("--halo", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_conv", type=int, default=32)
    p.add_argument("--bf16", action="store_true",
                   help="skip int8 PTQ, export the packed bf16 path")
    p.add_argument("--u8-io", action="store_true",
                   help="uint8 tiles in and out, /255 and clip/round inside "
                        "the graph")
    p.add_argument("--qat-ckpt", default=None,
                   help="ckpt_{iter}.pth of a train.quant_opt run: export "
                        "its EMA weights at the learned activation scales "
                        "(implies int8)")
    p.add_argument("--num_feat", type=int, default=64)
    p.add_argument("--upscale", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default "
                   "cuda)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    io = "u8" if args.u8_io else "bf16"
    program, meta, serve = build_engine(
        num_feat=args.num_feat, num_conv=args.num_conv, upscale=args.upscale,
        tile=args.tile, halo=args.halo, batch=args.batch, pth=args.pth,
        int8=not args.bf16, seed=args.seed, io=io, qat_ckpt=args.qat_ckpt,
        device=args.device)
    seconds = time.perf_counter() - t0

    # round-trip gate before writing: the exported program against the
    # live graph (the JAX exporter's ≥ 30 dB; here the same kernels run
    # both)
    size = args.tile + 2 * args.halo
    x = np.random.default_rng(0).random((args.batch, size, size, 3))
    x = (torch.from_numpy((x * 255).astype(np.uint8)) if io == "u8" else
         torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    db = round_trip_db(serve, program.module(), x.to(meta["device"]))
    print(f"engine vs live round trip: {db:.1f} dB")
    if db < 30.0:
        raise SystemExit(f"engine round trip too lossy: {db:.1f} dB")
    nbytes = save_engine(args.out, program, meta)
    print(f"engine: {nbytes / 2 ** 20:.1f} MiB, exported in {seconds:.1f} "
          f"s, {meta}")


if __name__ == "__main__":
    main()
