"""Distillation end to end on the card: an RRDB teacher, then two SRVGG
students from one init and one data stream, plain L1 against distilled,
and the distilled student served in int8.

Port of the repo-root `scripts/bench_distill_e2e.py`:

  stage T: train the RRDB teacher (SRModel, L1, grad_clip 1.0, the
           second-order Real-ESRGAN degradation on the device) under a
           wall budget; its checkpoint (`teacher.pth`: both heads and the
           iteration count) is rewritten after every chunk and read back
           by a later run (`--extend-teacher` trains it further);
  stage S: the students (grad_clip 1.0 too: JAX records an unclipped
           distilled student diverging), arm "l1" an SRModel, arm
           "distill" a DistillModel whose frozen bf16 teacher runs inside
           the step, both on a generator seeded `--student-seed`;
  stage E: one fixed degradation of held-out crops: PSNR/SSIM of the
           teacher's and each student's better head (EMA or live), each
           student against the teacher's output, then the distilled
           student PTQ-exported to the served int8 engine
           (`serve/sr_engine.py`, kernel K2) with its gap to the teacher,
           and its tiles/s at the serving geometry (tile 512, halo 8,
           8 tiles a call) against the trained teacher's float32 forward
           of one such tile.

The report is rewritten after each stage; earlier runs' teacher curves and
budget points in it are carried over.

    python -m image_restoration_tpu_torch.scripts.distill_e2e \\
        [--teacher-iters 4000] [--student-iters 2000] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.distill_e2e --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .qat_distill import _span_psnr, _sync, int8_engine
from .train_convergence import (EXP as _EXP, device_pool, log, photo_paths,
                                real_crops, realesrgan, train_loop,
                                write_report)

EXP = os.path.join(os.path.dirname(_EXP), "distill_e2e")
SERVE_CALLS = 20     # timed engine calls of the serving rate, after a warm-up


# ------------------------------------------------------------- builders

def teacher_options(num_block, gt_hw, scale=4, lr=2e-4):
    """SRModel options with an RRDBNet generator, the ESRGAN recipe's L1
    phase; grad_clip 1.0 (an unclipped RRDB-23 run collapsed on one bad
    batch in JAX's record)."""
    return {
        "is_train": True, "manual_seed": 0, "num_devices": 1,
        "scale": scale, "gt_size": gt_hw,
        "path": {"models": os.path.join(EXP, "models")},
        "logger": {},
        "model_type": "SRModel",
        "network_g": dict(type="RRDBNet", scale=scale, num_feat=64,
                          num_block=num_block),
        "train": {
            "optim_g": {"type": "Adam", "lr": lr, "grad_clip": 1.0},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000],
                          "gamma": 0.5},
            "total_iter": 400000,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "ema_decay": 0.999,
        },
    }


def student_options(num_feat, num_conv, gt_hw, scale=4, lr=1e-3,
                    teacher_block=None, distill_w=1.0, pixel_w=0.5):
    """SRVGG student options: a plain SRModel (teacher_block None) or a
    DistillModel with a bf16 RRDBNet teacher of `teacher_block` blocks.
    Both arms share manual_seed 0, so network_g starts bit-equal."""
    train = {
        "optim_g": {"type": "Adam", "lr": lr, "grad_clip": 1.0},
        "scheduler": {"type": "MultiStepLR", "milestones": [400000],
                      "gamma": 0.5},
        "total_iter": 400000, "ema_decay": 0.999,
        "pixel_opt": {"type": "L1Loss",
                      "loss_weight": pixel_w if teacher_block else 1.0},
    }
    opt = {
        "is_train": True, "manual_seed": 0, "num_devices": 1,
        "scale": scale, "gt_size": gt_hw,
        "path": {"models": os.path.join(EXP, "models")},
        "logger": {},
        "model_type": "SRModel",
        "network_g": dict(type="SRVGGNetCompact", num_feat=num_feat,
                          num_conv=num_conv, upscale=scale),
        "train": train,
    }
    if teacher_block:
        opt["model_type"] = "DistillModel"
        opt["network_t"] = dict(type="RRDBNet", scale=scale, num_feat=64,
                                num_block=teacher_block, dtype="bf16")
        train["allow_random_teacher"] = True
        train["distill_opt"] = {"type": "L1Loss", "loss_weight": distill_w}
    return opt


def build_teacher_trainer(bs, num_block, gt_hw, scale=4, lr=2e-4,
                          device=None):
    from ..models import build_model
    model = build_model(teacher_options(num_block, gt_hw, scale, lr),
                        device=device)
    model.set_degradation_pipeline(realesrgan(scale))
    return model


def build_student_trainer(bs, num_feat, num_conv, gt_hw, scale=4, lr=1e-3,
                          teacher_block=None, distill_w=1.0, pixel_w=0.5,
                          device=None):
    from ..models import build_model
    model = build_model(student_options(num_feat, num_conv, gt_hw, scale,
                                        lr, teacher_block, distill_w,
                                        pixel_w), device=device)
    model.set_degradation_pipeline(realesrgan(scale))
    return model


# ------------------------------------------------------------- plumbing

def save_params(state, path):
    """torch.save through a temporary file, so a killed run leaves the
    previous checkpoint whole."""
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def heads_state(model):
    def cpu(net):
        return {k: v.detach().cpu().clone()
                for k, v in net.state_dict().items()}
    return {"params_g": cpu(model.net_g), "ema_g": cpu(model.net_g_ema)}


def write_artifact(out, path, final=False):
    """Mark the report complete or not and write it to `path` (if any)."""
    out["complete"] = bool(final)
    if path is not None:
        write_report(out, path)


def train_validated(model, pool, bs, total_iters, chunk, seed, val_fn,
                    label, out, curve_key, budget_s=None, ckpt_path=None,
                    iter_offset=0, artifact=None):
    """`train_loop` on a generator seeded `seed`, both heads validated
    after each chunk into out[curve_key], then the checkpoint (if
    ckpt_path) and the report rewritten. iter_offset shifts the recorded
    iterations when extending a restored teacher. Returns the iterations
    done."""
    curve = {"iters": [], "loss": [], "val_psnr_ema": [],
             "val_psnr_live": []}
    out[curve_key] = curve

    def record(done, losses, dt):
        loss = float(losses["l_pix"].mean())
        p_ema, p_live = val_fn(model.net_g_ema), val_fn(model.net_g)
        curve["iters"].append(done + iter_offset)
        curve["loss"].append(round(loss, 5))
        curve["val_psnr_ema"].append(round(p_ema, 3))
        curve["val_psnr_live"].append(round(p_live, 3))
        log(f"  {label} iter {done + iter_offset:5d}: loss {loss:.4f} val "
            f"{p_ema:.2f} dB (ema) / {p_live:.2f} dB (live) "
            f"[{dt:.1f}s/chunk]")
        if ckpt_path:
            save_params({**heads_state(model),
                         "iters": done + iter_offset}, ckpt_path)
        write_artifact(out, artifact)

    gen = torch.Generator(pool.device).manual_seed(seed)
    return train_loop(model, pool, bs, total_iters, chunk, gen, ("l_pix",),
                      label, record, budget_s)


def tiles_per_sec(fn, x, calls):
    """Tiles of `x` per second through `fn`: the median of `calls` timed
    calls (host clock, synchronized), after one warm-up."""
    with torch.inference_mode():
        fn(x)
        times = []
        for _ in range(calls):
            _sync(x.device)
            t0 = time.perf_counter()
            fn(x)
            _sync(x.device)
            times.append(time.perf_counter() - t0)
    return x.shape[0] / float(np.median(times))


def carried_history(path, extend_teacher):
    """(teacher curve history, budget points) of the report at `path` from
    earlier runs: an earlier teacher curve joins the history when this run
    extends it (or the history is empty); an earlier complete run becomes
    a budget point."""
    if not path or not os.path.isfile(path):
        return [], []
    with open(path) as f:
        old = json.load(f)
    hist = list(old.get("teacher_curve_history", []))
    if old.get("teacher_curve") and (extend_teacher or not hist):
        hist.append(old["teacher_curve"])
    pts = list(old.get("budget_points", []))
    if old.get("complete") and old.get("student_l1"):
        pt = {"student_iters": old["student_l1"]["iters"],
              "student_seed": old.get("student_seed", 2),
              "teacher_psnr": old.get("teacher_psnr"),
              "l1_psnr": old["student_l1"]["psnr"],
              "distill_psnr": old["student_distill"]["psnr"],
              "distill_minus_l1_db": old.get("distill_minus_l1_db"),
              "distill_gap_to_teacher_db":
                  old["student_distill"]["gap_to_teacher_db"],
              "int8_gap_to_teacher_db":
                  old.get("student_distill_int8", {}).get(
                      "gap_to_teacher_db"),
              "date": old.get("date")}
        if (pt["student_iters"], pt["student_seed"]) not in [
                (p["student_iters"], p.get("student_seed", 2))
                for p in pts]:
            pts.append(pt)
    return hist, pts


# ------------------------------------------------------------------ main

def run(teacher_iters=4000, teacher_budget_s=1500.0, student_iters=2000,
        student_budget_s=480.0, bs=8, chunk=100, gt=256, teacher_blocks=23,
        teacher_only=False, student_seed=2, extend_teacher=False, tiny=False,
        device=None, gt_dir=None, out_path=None, exp_dir=EXP):
    """The three stages; returns (JAX's report, evidence): the evidence
    holds the K2 launches of the int8 scoring call and the students'
    chunk losses."""
    from ..metrics.psnr_ssim import calculate_ssim
    from ..ops.int8_conv import int8_conv3x3_requant as k2
    from ..utils.device import resolve_device
    device = resolve_device(device)
    num_feat, num_conv = (8, 2) if tiny else (64, 32)
    scale = 4
    paths = photo_paths(gt_dir)
    pool = device_pool(real_crops(gt, 8 if tiny else 64,
                                  np.random.default_rng(0), paths), device)
    val_imgs = device_pool(real_crops(gt, 2 if tiny else 8,
                                      np.random.default_rng(7), paths),
                           device)
    out = {"date": time.strftime("%Y-%m-%d"), "bs": bs, "gt": gt,
           "teacher": f"RRDBNet-{teacher_blocks} L1, lr 2e-4",
           "student": f"SRVGG {num_feat}f/{num_conv}c x4, lr 1e-3, "
                      "same init + data stream both arms",
           "val": "held-out crops, one fixed 2nd-order degradation",
           "timing": f"eager steps on {device}, losses read once a chunk"}
    hist, pts = carried_history(out_path, extend_teacher)
    out["teacher_curve_history"] = hist
    out["budget_points"] = pts
    out["student_seed"] = student_seed
    evidence = {}

    degrade = realesrgan(scale)
    with torch.no_grad():
        lq_val, gt_val = degrade(torch.Generator(device).manual_seed(123),
                                 val_imgs)
    gt_val_np = gt_val.float().cpu().numpy()

    @torch.no_grad()
    def forward(net, lq=lq_val):
        o = net(lq)
        return (o[0] if isinstance(o, tuple) else o).float()

    def span_psnr(ref, got):
        return _span_psnr(ref, np.clip(np.asarray(got, np.float64), 0, 1))

    def val_psnr(net):
        o = torch.clamp(forward(net), 0, 1)
        mse = torch.mean((o - gt_val.float()) ** 2)
        return float(10 * torch.log10(1.0 / mse))

    def quality(o):
        """PSNR (span) and mean SSIM against the val GT."""
        got = np.clip(o.float().cpu().numpy(), 0, 1)
        ssim = float(np.mean([calculate_ssim(
            got[i] * 255.0, gt_val_np[i] * 255.0, crop_border=scale)
            for i in range(got.shape[0])]))
        return round(span_psnr(gt_val_np, got), 3), round(ssim, 4)

    # ---------------------------------------------------- stage T: teacher
    os.makedirs(exp_dir, exist_ok=True)
    t_ckpt = os.path.join(exp_dir, "teacher.pth")
    teacher = build_teacher_trainer(bs, teacher_blocks, gt, scale,
                                    device=device)
    prev = (torch.load(t_ckpt, map_location="cpu", weights_only=True)
            if os.path.isfile(t_ckpt) and not tiny else None)
    if prev is not None and not extend_teacher:
        t_params = {"params_g": prev["params_g"], "ema_g": prev["ema_g"]}
        out["teacher_iters"] = int(prev["iters"])
        log(f"stage T: restored teacher at iter {out['teacher_iters']} "
            f"from {t_ckpt}")
    else:
        off = 0
        if prev is not None:  # --extend-teacher: warm-start both heads
            off = int(prev["iters"])
            teacher.net_g.load_state_dict(prev["params_g"])
            teacher.net_g_ema.load_state_dict(prev["ema_g"])
            log(f"stage T: extending teacher from iter {off} (fresh "
                "optimizer moments, fresh data-stream seed)")
        log(f"stage T: training RRDB-{teacher_blocks} teacher "
            f"(<={teacher_iters} iters, <={teacher_budget_s:.0f}s)")
        t_done = train_validated(
            teacher, pool, bs, teacher_iters, chunk, seed=1 + off,
            val_fn=val_psnr, label="teacher", out=out,
            curve_key="teacher_curve", budget_s=teacher_budget_s,
            ckpt_path=None if tiny else t_ckpt, iter_offset=off,
            artifact=out_path)
        t_params = heads_state(teacher)
        out["teacher_iters"] = off + t_done
        if not tiny:
            save_params({**t_params, "iters": off + t_done}, t_ckpt)

    # the better teacher head (the EMA lags at short horizons)
    net = teacher.net_g_ema
    net.load_state_dict(t_params["ema_g"])
    q_ema = quality(forward(net))
    net.load_state_dict(t_params["params_g"])
    q_live = quality(forward(net))
    use_ema = q_ema[0] >= q_live[0]
    teacher_sd = t_params["ema_g" if use_ema else "params_g"]
    out["teacher_psnr"], out["teacher_ssim"] = max(q_ema, q_live)
    out["teacher_head"] = "ema" if use_ema else "live"
    net.load_state_dict(teacher_sd)
    t_out_val = forward(net).cpu().numpy()
    log(f"teacher val: {out['teacher_psnr']} dB / SSIM "
        f"{out['teacher_ssim']} ({out['teacher_head']} head)")
    write_artifact(out, out_path)
    if teacher_only:
        log("--teacher-only: stopping after stage T")
        return out, evidence

    # --------------------------------------------- stage S: student arms
    arms = {}
    for arm in ("l1", "distill"):
        log(f"stage S: student arm '{arm}' (<={student_iters} iters)")
        model = build_student_trainer(
            bs, num_feat, num_conv, gt, scale,
            teacher_block=teacher_blocks if arm == "distill" else None,
            device=device)
        if arm == "distill":
            model.set_teacher_params(teacher_sd)
        done = train_validated(
            model, pool, bs, student_iters, chunk, seed=student_seed,
            val_fn=val_psnr, label=f"student-{arm}", out=out,
            curve_key=f"student_{arm}_curve", budget_s=student_budget_s,
            artifact=out_path)
        arms[arm] = (model, done)

    # ------------------------------------------------------ stage E: eval
    selected = {}
    for arm, (model, done) in arms.items():
        o_ema, o_live = forward(model.net_g_ema), forward(model.net_g)
        (p_e, s_e), (p_l, s_l) = quality(o_ema), quality(o_live)
        head = "ema" if p_e >= p_l else "live"
        psnr, ssim = max((p_e, s_e), (p_l, s_l))
        sel = model.net_g_ema if head == "ema" else model.net_g
        vs_teacher = round(span_psnr(
            t_out_val, (o_ema if head == "ema" else o_live).cpu().numpy()),
            3)
        out[f"student_{arm}"] = {
            "iters": done, "head": head, "psnr": psnr, "ssim": ssim,
            "vs_teacher_out_psnr": vs_teacher,
            "gap_to_teacher_db": round(out["teacher_psnr"] - psnr, 3)}
        selected[arm] = sel
        log(f"student-{arm}: {psnr} dB / SSIM {ssim} ({head}), "
            f"{out[f'student_{arm}']['gap_to_teacher_db']:+.3f} dB below "
            f"teacher, {vs_teacher} dB vs teacher output")
    out["distill_minus_l1_db"] = round(
        out["student_distill"]["psnr"] - out["student_l1"]["psnr"], 3)
    write_artifact(out, out_path)

    # the distilled student as served: PTQ int8 engine on K2
    with torch.no_grad():
        calib_lq, _ = degrade(torch.Generator(device).manual_seed(99),
                              pool[:4])
    with tempfile.TemporaryDirectory(prefix="irt_distill_") as tmp:
        engine = int8_engine(tmp, num_feat, num_conv, scale, device,
                             net=selected["distill"], calib=calib_lq)
    before = k2.launches
    p_q, s_q = quality(engine(lq_val))
    evidence["k2_launches_int8_call"] = k2.launches - before
    out["student_distill_int8"] = {
        "psnr": p_q, "ssim": s_q,
        "gap_to_teacher_db": round(out["teacher_psnr"] - p_q, 3)}
    log(f"student-distill served int8: {p_q} dB / SSIM {s_q} "
        f"({out['student_distill_int8']['gap_to_teacher_db']:+.3f} dB "
        f"below teacher); K2 {evidence['k2_launches_int8_call']} launches")
    out["budget_points"].append({
        "student_iters": out["student_l1"]["iters"],
        "student_seed": student_seed,
        "teacher_psnr": out["teacher_psnr"],
        "l1_psnr": out["student_l1"]["psnr"],
        "distill_psnr": out["student_distill"]["psnr"],
        "distill_minus_l1_db": out["distill_minus_l1_db"],
        "distill_gap_to_teacher_db":
            out["student_distill"]["gap_to_teacher_db"],
        "int8_gap_to_teacher_db":
            out["student_distill_int8"]["gap_to_teacher_db"],
        "date": out["date"]})

    # serving rate at the engine's geometry, and the teacher's there
    tile, halo, sbs = (32, 8, 2) if tiny else (512, 8, 8)
    s = tile + 2 * halo
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((sbs, s, s, 3), generator=gen).to(device)
    calls = 2 if tiny else SERVE_CALLS
    tps = tiles_per_sec(engine, x.to(torch.bfloat16), calls)
    teacher_tps = tiles_per_sec(net, x[:1], 2 if tiny else 3)
    out["served_tiles_per_sec"] = round(tps, 2)
    out["served_geometry"] = (f"tile={tile} halo={halo} bs={sbs} "
                              "packed2-int8")
    out["speedup_vs_rrdb_serving"] = round(tps / teacher_tps, 1)
    evidence["teacher_tiles_per_sec"] = teacher_tps
    log(f"distilled student serving: {tps:.1f} tiles/s "
        f"({out['served_geometry']}); the RRDB-{teacher_blocks} teacher's "
        f"float32 forward there {teacher_tps:.2f} tiles/s: "
        f"{out['speedup_vs_rrdb_serving']}x")
    evidence["curves"] = {arm: out[f"student_{arm}_curve"] for arm in arms}
    write_artifact(out, out_path, final=True)
    return out, evidence


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="1-block teacher and 8f/2c students at 64², 4 "
                         "iterations each, on the CPU")
    ap.add_argument("--teacher-iters", type=int, default=4000)
    ap.add_argument("--teacher-budget-s", type=float, default=1500.0,
                    help="teacher stage wall budget (adaptive iters)")
    ap.add_argument("--student-iters", type=int, default=2000)
    ap.add_argument("--student-budget-s", type=float, default=480.0)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--gt", type=int, default=256)
    ap.add_argument("--teacher-blocks", type=int, default=23)
    ap.add_argument("--teacher-only", action="store_true",
                    help="stop after stage T (teacher train + eval)")
    ap.add_argument("--student-seed", type=int, default=2,
                    help="data-stream seed shared by both student arms")
    ap.add_argument("--extend-teacher", action="store_true",
                    help="resume the teacher checkpoint and train it further "
                         "for --teacher-budget-s")
    ap.add_argument("--gt-dir", default=None,
                    help="photos to crop the GT from (default: seeded "
                         "synthetic plate scenes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(EXP, "distill_e2e.json"))
    args = ap.parse_args(argv)
    if args.tiny:
        args.teacher_iters, args.student_iters = 4, 4
        args.teacher_budget_s = args.student_budget_s = 1e9
        args.bs, args.chunk, args.gt, args.teacher_blocks = 2, 2, 64, 1
        args.device = args.device or "cpu"
    out, evidence = run(
        args.teacher_iters, args.teacher_budget_s, args.student_iters,
        args.student_budget_s, args.bs, args.chunk, args.gt,
        args.teacher_blocks, args.teacher_only, args.student_seed,
        args.extend_teacher, args.tiny, args.device, args.gt_dir, args.out,
        os.path.dirname(os.path.abspath(args.out)))
    if args.teacher_only:
        print(json.dumps({"ok": True, "teacher_only": True,
                          "teacher_iters": out["teacher_iters"],
                          "teacher_psnr": out["teacher_psnr"]}), flush=True)
        return out, evidence
    print(json.dumps({
        "metric": "distill_gap_to_teacher_db_served_int8",
        "value": out["student_distill_int8"]["gap_to_teacher_db"],
        "unit": "dB", "tiles_per_sec": out["served_tiles_per_sec"],
        "distill_minus_l1_db": out["distill_minus_l1_db"],
        "k2_launches_int8_call": evidence["k2_launches_int8_call"]}),
        flush=True)
    return out, evidence


if __name__ == "__main__":
    main()
