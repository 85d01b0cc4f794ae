"""The production GFPGAN recipe, scaled down, end to end on the card: every
loss on, bf16, grad-clipped, then a served engine exported from the EMA.

Port of the repo-root `scripts/bench_gfpgan_longrun.py`. The reference
recipe is 200k iterations (Adam lr 2e-3 for G and D, MultiStepLR ×0.5 at
100k and 150k, the pyramid loss removed at 50k, R1 every 16, EMA
0.5^(32/10⁴)); `--recipe-scale` s divides every one of those constants
(10: 20k iterations, milestones 10k/15k, the pyramid removal at 5k). The
pyramid weight becomes 1e-12 from the removal iteration on, step by step
(`GFPGANModel.pyramid_weight`), and the lr follows the schedule at each
update.

Evidence: the losses, the EMA and live PSNR on one fixed degradation of
held-out crops every `--val-every`, NIQE of the EMA head every
`--niqe-every`, a snapshot of the EMA at `--snapshot-iter` scored against
the final one (with a strip lq | snapshot | final | gt), and a
`torch.export` engine of `Restorer(PRODUCTION_GFPGAN)` in bf16 at the final
EMA weights (`scripts/export_gfpgan.py`), its round trip against the live
restorer in dB. The state is checkpointed every `--save-every` iterations
(`state.pth`) and a later run resumes from it. A failure anywhere fails
the run.

    python -m image_restoration_tpu_torch.scripts.gfpgan_longrun \\
        [--iters 20000] [--recipe-scale 10] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.gfpgan_longrun --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .distill_e2e import save_params
from .train_convergence import (EXP as _EXP, FixedVal, build_gfpgan_trainer,
                                device_pool, log, photo_paths, real_crops,
                                train_loop, write_report)

EXP = os.path.join(os.path.dirname(_EXP), "gfpgan_longrun")
RECIPE = dict(total=200000, milestones=(100000, 150000), remove_pyr=50000)
NIQE_MIN_HW = 96     # NIQE's block size: a smaller image has no score


def recipe(scale):
    """(milestones, pyramid removal iteration) of the recipe / scale."""
    return (tuple(m // scale for m in RECIPE["milestones"]),
            RECIPE["remove_pyr"] // scale)


def schedule_at(it, milestones, remove_pyr, base_lr=2e-3,
                pyramid_weight=1.0):
    """(G lr, pyramid weight) the recipe gives the step of iteration `it`
    (0-based: the lr halves at each milestone ≤ it; the pyramid weight is
    1e-12 from `remove_pyr` on)."""
    lr = base_lr * 0.5 ** sum(1 for m in milestones if it >= m)
    return lr, (pyramid_weight if it < remove_pyr else 1e-12)


def export_engine(model, net_opt, dtype, batch, hw, out_dir, iters):
    """Export `Restorer(net_opt)` at the model's EMA weights (through a
    `.pth` in the reference layout), check its round trip against the
    live restorer (≥ 30 dB, the exporter's gate) and save it under
    `out_dir`. Returns its dB."""
    from ..serve.engine_restorer import save_engine
    from .export_gfpgan import build_engine, round_trip_db
    with tempfile.TemporaryDirectory(prefix="irt_longrun_") as tmp:
        pth = os.path.join(tmp, "net_g_ema.pth")
        torch.save({"params_ema": {k: v.detach().cpu() for k, v in
                                   model.net_g_ema.state_dict().items()}},
                   pth)
        program, meta, live, _ = build_engine(
            net_opt=net_opt, pth=pth, batch=batch, dtype=dtype,
            device=model.device)
    db = round_trip_db(program.module(), live, meta)
    if db < 30.0:
        raise RuntimeError(f"engine round trip too lossy: {db:.1f} dB")
    meta.update(trained_iters=iters, roundtrip_db=round(db, 1),
                dtype=str(dtype))
    save_engine(out_dir, program, meta)
    log(f"engine exported ({db:.1f} dB round trip) -> {out_dir}")
    return db


def run(iters=20000, recipe_scale=10, bs=8, chunk=250, val_every=500,
        niqe_every=2000, snapshot_iter=5500, grad_clip=1.0, save_every=1000,
        budget_s=7200.0, tiny=False, no_export=False, device=None,
        gt_dir=None, exp_dir=EXP):
    """Train (resuming from `exp_dir`/state.pth when there), score, export.
    Returns (JAX's report, evidence): the evidence holds the lr and the
    pyramid weight of every step run, and the engine's dB."""
    from ..infer import PRODUCTION_GFPGAN
    from ..metrics.niqe import calculate_niqe
    from ..utils.device import resolve_device
    device = resolve_device(device)
    total = iters
    milestones, remove_pyr = recipe(recipe_scale)
    dtype = None if tiny else torch.bfloat16
    hw = 32 if tiny else 256
    model = build_gfpgan_trainer(
        bs, dtype=dtype, tiny_net=tiny, img_hw=hw, total_iter=total,
        milestones=milestones, remove_pyramid_loss=remove_pyr,
        grad_clip=grad_clip, device=device)
    paths = photo_paths(gt_dir)
    pool = device_pool(real_crops(hw, 8 if tiny else 128,
                                  np.random.default_rng(0), paths), device)
    val_imgs = device_pool(real_crops(hw, 2 if tiny else 8,
                                      np.random.default_rng(7), paths),
                           device)
    val = FixedVal(model.degrade_fn, val_imgs, (-1.0, 1.0))

    def val_niqe(out, n=4):
        """Mean NIQE of the first n val outputs `out` (None below 96²)."""
        if hw < NIQE_MIN_HW:
            return None
        out = out[:n].cpu().numpy()
        imgs = np.clip((out + 1) * 127.5, 0, 255)[..., ::-1]  # BGR
        return round(float(np.mean([calculate_niqe(
            im, crop_border=0, convert_to="y") for im in imgs])), 3)

    os.makedirs(exp_dir, exist_ok=True)
    ckpt = os.path.join(exp_dir, "state.pth")
    snap_path = os.path.join(exp_dir, "snapshot.pth")
    report_path = os.path.join(exp_dir, "gfpgan_longrun.json")
    curve = {"iters": [], "l_pix": [], "l_d": [], "l_gan": [],
             "val_psnr_ema": [], "val_psnr_live": [], "lr_g": []}
    niqe_curve = {"iters": [], "niqe_ema": []}
    if not tiny and os.path.isfile(ckpt):
        model.load_training_state(torch.load(ckpt, map_location=device,
                                             weights_only=True))
        if os.path.isfile(report_path):
            with open(report_path) as f:
                old = json.load(f)
            curve = old.get("curve", curve)
            niqe_curve = old.get("niqe_curve", niqe_curve)
        log(f"resumed from {ckpt} at iter {model.iter}")
    done = model.iter

    out = {
        "date": time.strftime("%Y-%m-%d"),
        "config": f"production recipe / {recipe_scale}: {total} iters, "
                  f"MultiStepLR x0.5 @ {list(milestones)}, "
                  f"remove_pyramid_loss {remove_pyr}, R1/16, EMA, "
                  f"VGG perceptual+style, wgan_softplus, "
                  f"grad_clip {grad_clip}, bs {bs}, "
                  f"{'f32' if dtype is None else 'bf16'}",
        "data": f"{hw}² GT crops on {device}, production FFHQ degradation "
                "(fresh kernels each iter)",
        "curve": curve, "niqe_curve": niqe_curve,
    }

    def write(final=False):
        out["complete"] = bool(final)
        write_report(out, report_path)

    evidence = {"lr_g": [], "pyr_w": [], "iters": []}
    keys = ("l_g_pix", "l_d", "l_g_gan")

    def record(done, losses, dt):
        evidence["iters"].extend(range(done - chunk, done))
        evidence["lr_g"].extend(losses["lr_g"].tolist())
        evidence["pyr_w"].extend(losses["pyr_w"].tolist())
        if done % val_every < chunk:
            means = {k: float(losses[k].mean()) for k in keys}
            p_ema = val.psnr(model.net_g_ema, True)
            p_live = val.psnr(model.net_g, True)
            lr = model.optimizer_g.schedule(done)
            curve["iters"].append(done)
            for k, key in zip(("l_pix", "l_d", "l_gan"), keys):
                curve[k].append(round(means[key], 5))
            curve["val_psnr_ema"].append(round(p_ema, 3))
            curve["val_psnr_live"].append(round(p_live, 3))
            curve["lr_g"].append(lr)
            log(f"iter {done:6d}: l_pix {means['l_g_pix']:.4f} "
                f"l_d {means['l_d']:.4f} l_gan {means['l_g_gan']:.4f} val "
                f"{p_ema:.2f} dB (ema) / {p_live:.2f} (live) lr {lr:.1e} "
                f"pyr_w {losses['pyr_w'][-1]:g} [{dt:.1f}s/chunk]")
        if done % niqe_every < chunk:
            nq = val_niqe(val.out(model.net_g_ema, True))
            niqe_curve["iters"].append(done)
            niqe_curve["niqe_ema"].append(nq)
            log(f"  NIQE(ema) at {done}: {nq}")
        if done % save_every < chunk or done >= total:
            save_params(model.training_state(), ckpt)
        if abs(done - snapshot_iter) < chunk and not os.path.isfile(
                snap_path):
            save_params({"ema_g": model.net_g_ema.state_dict(),
                         "iter": done}, snap_path)
            log(f"  snapshot saved at iter {done}")
        write()

    gen = torch.Generator(device).manual_seed(42)
    t_start = time.perf_counter()
    log(f"iter {done}: val PSNR {val.psnr(model.net_g_ema, True):.2f} dB "
        f"(ema), pyramid removal at {remove_pyr}, milestones {milestones}")
    done = train_loop(model, pool, bs, total, chunk, gen, keys, "long run",
                      record, budget_s, done, record_schedule=True)
    if done > 0:
        save_params(model.training_state(), ckpt)

    out["iters_done"] = done
    out["wall_minutes"] = round((time.perf_counter() - t_start) / 60, 1)

    # snapshot against final
    if os.path.isfile(snap_path) and done > snapshot_iter:
        snap = torch.load(snap_path, map_location=device, weights_only=True)
        final_sd = {k: v.clone() for k, v in
                    model.net_g_ema.state_dict().items()}
        comp = {"snapshot_iter": int(snap["iter"])}
        outs = {}
        for name, sd in (("snapshot", snap["ema_g"]), ("final", final_sd)):
            model.net_g_ema.load_state_dict(sd)
            o = val.out(model.net_g_ema, True)
            outs[name] = o.cpu().numpy()
            comp[f"{name}_psnr"] = round(val.psnr_of(o), 3)
            comp[f"{name}_niqe"] = val_niqe(o)
        comp["final_minus_snapshot_psnr_db"] = round(
            comp["final_psnr"] - comp["snapshot_psnr"], 3)
        out["snapshot_vs_final"] = comp
        log(f"snapshot@{comp['snapshot_iter']} vs final@{done}: "
            f"{comp['snapshot_psnr']} -> {comp['final_psnr']} dB "
            f"({comp['final_minus_snapshot_psnr_db']:+.3f}); NIQE "
            f"{comp['snapshot_niqe']} -> {comp['final_niqe']}")
        out["compare_png"] = save_strip(
            os.path.join(exp_dir, "gfpgan_longrun_compare.png"), val, outs,
            hw)

    if not no_export and done >= total:
        net_opt = (dict(PRODUCTION_GFPGAN) if not tiny else
                   {k: v for k, v in model.opt["network_g"].items()
                    if k not in ("dtype", "fix_decoder")})
        eng_dir = os.path.join(exp_dir, "engine")
        db = export_engine(model, net_opt, torch.bfloat16 if not tiny
                           else None, 2 if tiny else 8, hw, eng_dir, done)
        out["engine"] = {"dir": eng_dir, "roundtrip_db": round(db, 1)}
        evidence["engine_db"] = db
    write(final=done >= total)
    return out, evidence


def save_strip(path, val, outs, hw, n=4):
    """Rows of lq (nearest-upsampled) | snapshot | final | gt."""
    import cv2

    def u8(a, lo=-1.0, hi=1.0):
        a = (np.asarray(a, np.float32) - lo) / (hi - lo)
        return (np.clip(a, 0, 1) * 255).astype(np.uint8)
    lq = val.lq.float().cpu().numpy()
    gt = val.gt.float().cpu().numpy()
    n = min(n, lq.shape[0])
    rows = [np.concatenate(
        [cv2.resize(u8(lq[i]), (hw, hw), interpolation=cv2.INTER_NEAREST),
         u8(outs["snapshot"][i]), u8(outs["final"][i]), u8(gt[i])], axis=1)
        for i in range(n)]
    cv2.imwrite(path, np.concatenate(rows, axis=0)[..., ::-1])
    return f"{path} (lq|snapshot|final|gt)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--recipe-scale", type=int, default=10,
                    help="divide every production schedule constant by "
                         "this (200k recipe -> 20k at 10)")
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--val-every", type=int, default=500)
    ap.add_argument("--niqe-every", type=int, default=2000)
    ap.add_argument("--snapshot-iter", type=int, default=5500)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--save-every", type=int, default=1000,
                    help="checkpoint cadence in iterations")
    ap.add_argument("--budget-s", type=float, default=7200.0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny nets at 32², 4 iterations of batch 2, f32, on "
                         "the CPU")
    ap.add_argument("--no-export", action="store_true")
    ap.add_argument("--gt-dir", default=None,
                    help="photos to crop the GT from (default: seeded "
                         "synthetic plate scenes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(EXP, "gfpgan_longrun.json"),
                    help="the report; the checkpoints, the snapshot, the "
                         "strip and the engine go beside it")
    args = ap.parse_args(argv)
    if args.tiny:
        args.iters, args.chunk, args.val_every = 4, 2, 2
        args.niqe_every, args.snapshot_iter = 2, 2
        args.bs, args.budget_s = 2, 1e9
        args.device = args.device or "cpu"
    exp_dir = os.path.dirname(os.path.abspath(args.out))
    out, _ = run(args.iters, args.recipe_scale, args.bs, args.chunk,
                 args.val_every, args.niqe_every, args.snapshot_iter,
                 args.grad_clip, args.save_every, args.budget_s, args.tiny,
                 args.no_export, args.device, args.gt_dir, exp_dir)
    if os.path.abspath(args.out) != os.path.join(exp_dir,
                                                 "gfpgan_longrun.json"):
        write_report(out, args.out)
    curve, niqe = out["curve"], out["niqe_curve"]
    print(json.dumps({
        "metric": "gfpgan_longrun_val_psnr_ema_db",
        "value": curve["val_psnr_ema"][-1] if curve["val_psnr_ema"] else None,
        "iters": out["iters_done"],
        "niqe": niqe["niqe_ema"][-1] if niqe["niqe_ema"] else None}),
        flush=True)
    return out


if __name__ == "__main__":
    main()
