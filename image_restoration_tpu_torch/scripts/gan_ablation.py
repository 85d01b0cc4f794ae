"""GAN against L1: does the adversarial + perceptual stack do its job?

Port of the repo-root `scripts/bench_gan_ablation.py`. Two arms train from
one G/D init (manual_seed 0) on one data stream (a generator seeded 5 on
the device: the same degradations, StyleConv noise and pool rotation)
for the same iteration budget:

  arm "gan": the production step, pixel + pyramid + perceptual (+ style)
             + wgan_softplus through D, D's update and R1 every 16;
  arm "l1":  the same step graph with gan loss_weight 0 and no perceptual
             loss: G's gradient carries only the pixel and pyramid terms.

Both arms run with cuDNN's deterministic algorithms, so two runs of one seed
agree. Each arm's better head (EMA or live) is then scored on one fixed
degradation of held-out crops: PSNR and SSIM against the GT, the
gradient-magnitude similarity (GMS, Sobel on Y, c = 170) and NIQE over a
montage of the outputs (lower is better), with a triptych (lq | output |
gt) per arm beside the report.

    python -m image_restoration_tpu_torch.scripts.gan_ablation \\
        [--iters 3000] [--bs 8] [--gt-dir photos/] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.gan_ablation --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .train_convergence import (EXP as _EXP, FixedVal, build_gfpgan_trainer,
                                device_pool, log, photo_paths, real_crops,
                                train_loop, write_report)

EXP = os.path.join(os.path.dirname(_EXP), "gan_ablation")
NIQE_BLOCK = 96      # NIQE's block size: a smaller image has no score
ARMS = {"gan": dict(perceptual=True, gan_weight=0.1),
        "l1": dict(perceptual=False, gan_weight=0.0)}
PROBED_BATCHES = 3   # LQ batches each arm keeps, to show the streams agree


# -------------------------------------------------------------- metrics

def to_u8_rgb(img_m11: np.ndarray) -> np.ndarray:
    """[-1,1] float RGB → [0,255] uint8 RGB."""
    return np.clip((np.asarray(img_m11, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


def gradient_similarity(out_u8: np.ndarray, gt_u8: np.ndarray) -> float:
    """Mean gradient-magnitude similarity (GMS, c=170) over a batch:
    (2·m_x·m_y + c) / (m_x² + m_y² + c) of the Sobel gradient magnitudes
    on the gray channel, 1.0 for identical edges."""
    import cv2
    c = 170.0
    scores = []
    for o, g in zip(out_u8, gt_u8):
        oy = cv2.cvtColor(o, cv2.COLOR_RGB2GRAY).astype(np.float64)
        gy = cv2.cvtColor(g, cv2.COLOR_RGB2GRAY).astype(np.float64)
        mo = np.hypot(cv2.Sobel(oy, cv2.CV_64F, 1, 0, ksize=3),
                      cv2.Sobel(oy, cv2.CV_64F, 0, 1, ksize=3))
        mg = np.hypot(cv2.Sobel(gy, cv2.CV_64F, 1, 0, ksize=3),
                      cv2.Sobel(gy, cv2.CV_64F, 0, 1, ksize=3))
        scores.append(float(np.mean((2 * mo * mg + c) /
                                    (mo ** 2 + mg ** 2 + c))))
    return float(np.mean(scores))


def _montage(batch_u8_rgb: np.ndarray) -> np.ndarray:
    """The batch on an exact divisor grid (no filler cells)."""
    n, h, w, _ = batch_u8_rgb.shape
    cols = max(c for c in range(1, n + 1) if n % c == 0
               and c <= np.sqrt(n) * 2)
    rows = n // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(batch_u8_rgb):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return grid


def montage_niqe(batch_u8_rgb: np.ndarray) -> float:
    """NIQE over one montage of the whole batch (more 96² blocks → a
    stabler covariance than per-image scoring)."""
    from ..metrics.niqe import calculate_niqe
    bgr = _montage(batch_u8_rgb)[..., ::-1].astype(np.float32)
    return float(calculate_niqe(bgr, crop_border=0, convert_to="y"))


def niqe_or_none(batch_u8_rgb: np.ndarray):
    """`montage_niqe`, or None when the montage holds no NIQE block."""
    h, w = _montage(batch_u8_rgb).shape[:2]
    if min(h, w) < NIQE_BLOCK:
        return None
    return round(montage_niqe(batch_u8_rgb), 3)


def save_triptych(path, lq_u8, out_u8, gt_u8, max_rows=4):
    """Rows of (lq | output | gt) for human inspection."""
    import cv2
    rows = [np.concatenate([lq_u8[i], out_u8[i], gt_u8[i]], axis=1)
            for i in range(min(max_rows, len(out_u8)))]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, np.concatenate(rows, axis=0)[..., ::-1])


def _probe_lq(model, store):
    """Keep a CPU copy of the first PROBED_BATCHES LQ batches the model's
    step degrades."""
    degrade = model.degrade

    def probed(batch, generator=None):
        lq, gt = degrade(batch, generator)
        if len(store) < PROBED_BATCHES:
            store.append(lq.detach().cpu().clone())
        return lq, gt
    model.degrade = probed


# ------------------------------------------------------------------ main

def run(*args, **kwargs):
    """Both arms (`_run_arms`) with cuDNN's deterministic algorithms: its
    default backward algorithms are not, and GAN steps amplify their
    rounding, so without them two runs of one seed end dBs apart and the
    arms' difference is lost in it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _run_arms(*args, **kwargs)
    finally:
        torch.backends.cudnn.deterministic = saved


def _run_arms(iters=3000, budget_s=1200.0, chunk=100, bs=8, hw=256,
              tiny=False, device=None, gt_dir=None, out_dir=None):
    """Both arms; returns (JAX's report, evidence): the evidence holds what
    the report does not, the arms' iteration-0 PSNR, whether they started
    bit-equal and saw bit-equal LQ batches, and the triptychs' paths (under
    `out_dir`, when given)."""
    from ..metrics.psnr_ssim import calculate_ssim
    from ..utils.device import resolve_device
    device = resolve_device(device)
    paths = photo_paths(gt_dir)
    pool = device_pool(real_crops(hw, 8 if tiny else 64,
                                  np.random.default_rng(0), paths), device)
    val_imgs = device_pool(real_crops(hw, 2 if tiny else 8,
                                      np.random.default_rng(7), paths),
                           device)
    out = {"date": time.strftime("%Y-%m-%d"), "bs": bs, "hw": hw,
           "setup": "same G/D init (manual_seed=0) + same data stream "
                    "(a generator seeded 5) + same iteration budget; arm "
                    "'gan' = production pixel+pyramid+perceptual+"
                    "wgan_softplus (+D, R1/16); arm 'l1' = identical graph "
                    "with gan_weight=0, no perceptual",
           "val": "held-out crops, one fixed FFHQ degradation"}
    evidence = {"p0": {}, "lq": {}, "init": {}, "triptychs": {}}
    evals = {}
    for arm, cfg in ARMS.items():
        log(f"arm '{arm}': <={iters} iters, <={budget_s:.0f}s wall")
        model = build_gfpgan_trainer(bs, img_hw=hw, tiny_net=tiny,
                                     device=device, **cfg)
        evidence["init"][arm] = [
            t.detach().cpu().clone() for net in (model.net_g, model.net_d)
            for t in net.state_dict().values()]
        evidence["lq"][arm] = []
        _probe_lq(model, evidence["lq"][arm])
        val = FixedVal(model.degrade_fn, val_imgs, (-1.0, 1.0))
        evidence["p0"][arm] = val.psnr(model.net_g_ema, True)
        gen = torch.Generator(device).manual_seed(5)   # one stream, both arms
        curve = {"iters": [], "l_pix": [], "l_d": [], "val_psnr_ema": [],
                 "val_psnr_live": []}
        out[f"{arm}_curve"] = curve

        def record(done, losses, dt):
            l_pix = float(losses["l_g_pix"].mean())
            p_ema = val.psnr(model.net_g_ema, True)
            p_live = val.psnr(model.net_g, True)
            curve["iters"].append(done)
            curve["l_pix"].append(round(l_pix, 5))
            curve["l_d"].append(round(float(losses["l_d"].mean()), 5))
            curve["val_psnr_ema"].append(round(p_ema, 3))
            curve["val_psnr_live"].append(round(p_live, 3))
            log(f"  {arm} iter {done:5d}: l_pix {l_pix:.4f} val {p_ema:.2f} "
                f"dB (ema) / {p_live:.2f} (live) [{dt:.1f}s/chunk]")

        done = train_loop(model, pool, bs, iters, chunk, gen,
                          ("l_g_pix", "l_d"), arm, record, budget_s)

        # the better head, scored on the fixed val pair
        heads = {"ema_g": val.out(model.net_g_ema, True),
                 "params_g": val.out(model.net_g, True)}
        psnr_of = {h: val.psnr_of(o) for h, o in heads.items()}
        head = max(psnr_of, key=psnr_of.get)
        o_u8 = to_u8_rgb(heads[head].cpu().numpy())
        lq_u8 = to_u8_rgb(val.lq.float().cpu().numpy())
        gt_u8 = to_u8_rgb(val.gt.float().cpu().numpy())
        ssim = float(np.mean([calculate_ssim(
            o_u8[i].astype(np.float32), gt_u8[i].astype(np.float32),
            crop_border=0) for i in range(len(o_u8))]))
        ev = {"iters": done, "head": head.replace("_g", ""),
              "psnr": round(psnr_of[head], 3), "ssim": round(ssim, 4),
              "gms_vs_gt": round(gradient_similarity(o_u8, gt_u8), 4),
              "niqe": niqe_or_none(o_u8)}
        evals[arm] = (o_u8, lq_u8, gt_u8)
        out[f"arm_{arm}"] = ev
        if out_dir:
            path = os.path.join(out_dir, f"gan_ablation_{arm}.png")
            save_triptych(path, lq_u8, o_u8, gt_u8)
            evidence["triptychs"][arm] = path
        log(f"  {arm}: {ev}")
        del model

    gan_ev, l1_ev = out["arm_gan"], out["arm_l1"]
    out["gan_minus_l1_psnr_db"] = round(gan_ev["psnr"] - l1_ev["psnr"], 3)
    out["gan_minus_l1_gms"] = round(
        gan_ev["gms_vs_gt"] - l1_ev["gms_vs_gt"], 4)
    # NIQE: lower is better, so a positive difference means GAN wins
    out["l1_minus_gan_niqe"] = (
        None if gan_ev["niqe"] is None or l1_ev["niqe"] is None
        else round(l1_ev["niqe"] - gan_ev["niqe"], 3))
    out["niqe_gt_anchor"] = niqe_or_none(evals["gan"][2])

    ia, ib = evidence.pop("init").values()
    la, lb = evidence.pop("lq").values()
    evidence["init_bit_equal"] = all(torch.equal(a, b) for a, b in
                                     zip(ia, ib)) and len(ia) == len(ib)
    evidence["lq_batches_compared"] = min(len(la), len(lb))
    evidence["lq_bit_equal"] = all(torch.equal(a, b) for a, b in
                                   zip(la, lb))
    return out, evidence


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny nets at 32², 2 iterations of batch 1 an arm, on "
                         "the CPU")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--budget-s", type=float, default=1200.0,
                    help="per-arm wall budget (adaptive iteration count)")
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--gt-dir", default=None,
                    help="photos to crop the GT from (default: seeded "
                         "synthetic plate scenes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(EXP, "gan_ablation.json"))
    args = ap.parse_args(argv)
    if args.tiny:
        args.iters, args.chunk, args.bs, args.hw = 2, 2, 1, 32
        args.budget_s = 1e9
        args.device = args.device or "cpu"
    out, evidence = run(args.iters, args.budget_s, args.chunk, args.bs,
                        args.hw, args.tiny, args.device, args.gt_dir,
                        os.path.dirname(os.path.abspath(args.out)))
    write_report(out, args.out)
    print(json.dumps({
        "metric": "gan_vs_l1",
        "gan_minus_l1_psnr_db": out["gan_minus_l1_psnr_db"],
        "gan_minus_l1_gms": out["gan_minus_l1_gms"],
        "l1_minus_gan_niqe": out["l1_minus_gan_niqe"],
        "niqe_gt_anchor": out["niqe_gt_anchor"],
        "init_bit_equal": evidence["init_bit_equal"],
        "lq_bit_equal": evidence["lq_bit_equal"]}), flush=True)
    return out, evidence


if __name__ == "__main__":
    main()
