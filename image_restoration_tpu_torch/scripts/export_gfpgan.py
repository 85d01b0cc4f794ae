"""Export the production GFPGAN restorer as a serving engine.

Port of the repo-root `scripts/export_gfpgan.py`. The reference serves its
plate and car restorers as TorchScript artifacts loaded without the model's
source (api_plate_oto.py:336 `torch.jit.load`); this writes the port's
counterpart: a `torch.export` program of `Restorer`'s device-IO graph
(uint8 RGB in, uint8 BGR out, normalization and output conversion inside,
weights inside) at a frozen (batch, H, W, 3) shape, K1 as the op
`irt::fused_bias_lrelu`. `serve.engine_restorer.EngineFaceRestorer` loads
it and slots into `ServiceCore(restorer=…)`, micro-batching included.

With `--with-geometry` it exports the fused post-detector graph instead
(`serve.pipeline.build_geo_fused`, the same restorer on the plate and the
car slot): (canvas_u8 (N, T, T, 3) BGR, quads (N, 4, 2) float32) →
(montage_u8 (N, T, 6T, 3), masked_canvas_u8), loaded by
`EngineGeoPipeline` into `PlatePipeline(geo_engine=…)`.

    python -m image_restoration_tpu_torch.scripts.export_gfpgan \\
        --out engine_gfpgan/ [--pth net_g.pth] [--batch 32] \\
        [--quant dyn-int8] [--bf16] [--with-geometry] [--device cuda]

The round trip (the exported program against the live graph, the JAX
exporter's ≥ 30 dB gate) is checked before anything is written. The
artifact runs only on the device type it was exported on.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..infer import PRODUCTION_GFPGAN, Restorer
from ..serve.engine_restorer import export_graph, save_engine


def plate_quads(batch: int, t: int) -> np.ndarray:
    """The exporter's check quads: one plate-like quad per canvas."""
    q = np.float32([[t // 5, t // 3], [4 * t // 5, t // 4],
                    [3 * t // 4, 2 * t // 3], [t // 6, 3 * t // 4]])
    return np.repeat(q[None], batch, 0)


def build_engine(net_opt=None, pth=None, batch=32, quant=None, dtype=None,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 out_min_max=(-1, 1), with_geometry=False, device=None,
                 seed=0):
    """Returns (program, meta, live, restorer): the torch.export program,
    its metadata, the live graph it was traced from, and the Restorer
    (JAX's `build_engine` returns serialized bytes in the program's place
    and no live graph). IO is uint8 always: the engine is the device-IO
    serving graph."""
    from ..serve.pipeline import build_geo_fused

    net_opt = dict(net_opt or PRODUCTION_GFPGAN)
    restorer = Restorer(net_opt, pth, quant=quant, dtype=dtype, mean=mean,
                        std=std, out_min_max=out_min_max, device=device,
                        seed=seed)
    h, w = restorer.input_size
    if h is None:
        raise ValueError("GFPGAN engines need a fixed input size "
                         "(net_opt input_height/input_width)")
    dev = restorer.device
    x = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=dev)
    if with_geometry:
        if h != w:
            raise ValueError("the fused geometry graph assumes a square "
                             f"canvas; got {h}x{w}")
        live = build_geo_fused(restorer, restorer, h)
        args = (x, torch.zeros((batch, 4, 2), device=dev))
    else:
        live, args = restorer.forward_u8, (x,)
    program = export_graph(live, args, [restorer.net])
    meta = {"model": net_opt["type"], "net_opt": net_opt, "batch": batch,
            "input_shape": [batch, h, w, 3], "input_dtype": "uint8",
            "io": "u8", "quant": quant, "mean": list(mean),
            "std": list(std), "out_min_max": list(out_min_max),
            "geometry": bool(with_geometry), "platforms": [dev.type],
            "device": str(dev)}
    return program, meta, live, restorer


def round_trip_db(engine, live, meta: dict) -> float:
    """PSNR (255 peak) of the engine's output against the live graph's on
    seeded uint8 inputs at the engine's shape: the montage with geometry,
    else the restore."""
    batch, h, w, _ = meta["input_shape"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((batch, h, w, 3)) * 255).astype(
        np.uint8)).to(meta["device"])
    args = (x, torch.from_numpy(plate_quads(batch, h)).to(
        meta["device"])) if meta["geometry"] else (x,)
    with torch.inference_mode():
        got, want = engine(*args), live(*args)
        if meta["geometry"]:
            got, want = got[0], want[0]
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    mse = float(np.mean((got - want) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--pth", default=None,
                   help="reference GFPGAN .pth (params_ema) to load")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--quant", default=None, choices=[None, "dyn-int8"])
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--with-geometry", action="store_true",
                   help="export the fused post-detector pipeline graph "
                        "(crop/mask/restores/warp/paste/montage) instead "
                        "of the bare restorer")
    p.add_argument("--seed", type=int, default=0,
                   help="weights from this seed when no --pth is given")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    program, meta, live, _ = build_engine(
        pth=args.pth, batch=args.batch, quant=args.quant,
        dtype=torch.bfloat16 if args.bf16 else None,
        with_geometry=args.with_geometry, device=args.device, seed=args.seed)
    seconds = time.perf_counter() - t0
    db = round_trip_db(program.module(), live, meta)
    print(f"engine vs live round trip: {db:.1f} dB")
    if db < 30.0:
        raise SystemExit(f"engine round trip too lossy: {db:.1f} dB")
    nbytes = save_engine(args.out, program, meta)
    print(f"engine: {nbytes / 2 ** 20:.1f} MiB, exported in {seconds:.1f} "
          f"s, {meta}")


if __name__ == "__main__":
    main()
