"""Serving-aware trainers at full width on the card: QAT against PTQ, and
the QAT and distillation step costs.

Port of the repo-root `scripts/bench_qat_distill.py`:

  1. qat_step: the QAT train step (SRVGG 64f/32c ×4 against the fake-quant
     twin of the int8 serving graph, `ops/qat.py`) against the float step,
     same f32 config, gt 256², the second-order degradation on the device;
  2. qat_vs_ptq: from one init and one data stream, float training then
     PTQ against QAT, both scored through the served int8 engine
     (`serve/sr_engine.py`, whose 34 int8 convs a call are kernel K2) on
     one fixed degradation of held-out crops;
  3. qat4_vs_ptq4 / qat2_vs_ptq2: the same at 4- and 2-bit weights, judged
     through the fake-quant twin at that width (no int8 engine serves
     them);
  4. distill_step: the RRDB-23 bf16 teacher's forward inside the SRVGG
     student's step.

Each step runs eagerly, the losses on the device until a chunk ends; a
step time is the host clock over `iters` steps ending in one synchronize,
the least of 3 runs.

    python -m image_restoration_tpu_torch.scripts.qat_distill \\
        [--gt-dir photos/] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.qat_distill --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .train_convergence import (EXP as _EXP, build_sr_trainer, device_pool,
                                log, photo_paths, real_crops, realesrgan,
                                train_chunk, train_loop, write_report)

EXP = os.path.join(os.path.dirname(_EXP), "qat_distill")
REPEATS = 3


def _span_psnr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    span = max(ref.max() - ref.min(), 1e-9)
    mse = float(np.mean((ref - got) ** 2))
    return 10 * np.log10(span ** 2 / max(mse, 1e-20))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(model, pool, bs, iters, device, repeats=REPEATS):
    """Seconds per train step: two warm-up steps, then the least over
    `repeats` runs of `iters` steps (host clock, one synchronize at the
    end of each); the warm-up's losses must be finite."""
    gen = torch.Generator(device).manual_seed(0)
    warm = train_chunk(model, pool, bs, 2, gen, ("l_pix",))["l_pix"]
    if not np.all(np.isfinite(warm)):
        raise FloatingPointError(f"non-finite losses: {warm}")
    best = float("inf")
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            start = min((i * bs) % pool.shape[0], pool.shape[0] - bs)
            model.optimize_parameters(model.iter,
                                      {"gt": pool[start:start + bs]}, gen)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_qat_step(bs=16, iters=16, num_feat=64, num_conv=32, gt_hw=256,
                   device=None, paths=None):
    """QAT against float train-step cost at the same f32 config."""
    rng_np = np.random.default_rng(0)
    pool = device_pool(real_crops(gt_hw, bs * 2, rng_np, paths), device)
    rows = []
    for quant in (False, True):
        model = build_sr_trainer(bs, gt_hw=gt_hw, num_feat=num_feat,
                                 num_conv=num_conv, quant=quant,
                                 device=device)
        sec = time_steps(model, pool, bs, iters, device)
        rows.append({"mode": "qat" if quant else "float", "bs": bs,
                     "ms_per_step": round(sec * 1e3, 2),
                     "imgs_per_sec": round(bs / sec, 1)})
        log(f"SR L1 step ({'QAT fake-quant' if quant else 'float f32'}) "
            f"bs={bs}: {sec * 1e3:.1f} ms/step = {bs / sec:.1f} imgs/s")
        del model
    overhead = rows[1]["ms_per_step"] / rows[0]["ms_per_step"] - 1.0
    log(f"QAT step overhead: {overhead * 100:.1f}%")
    return {"config": f"SRVGG {num_feat}f/{num_conv}c x4 f32, gt "
                      f"{gt_hw}², 2nd-order degradation on {device}",
            "rows": rows, "overhead_pct": round(overhead * 100, 1)}


class _Arms:
    """What the PTQ/QAT comparisons share: the pool, the held-out pair
    (one fixed degradation, a generator seeded 123), the calibration batch
    (4 pool crops degraded with a generator seeded 99) and the arms'
    training from one init and one data stream (a generator seeded
    seed + 1)."""

    def __init__(self, total_iters, chunk, bs, num_feat, num_conv, gt_hw,
                 scale, seed, device, paths):
        self.__dict__.update(total_iters=total_iters, chunk=chunk, bs=bs,
                             num_feat=num_feat, num_conv=num_conv,
                             gt_hw=gt_hw, scale=scale, seed=seed,
                             device=device)
        big = total_iters > 100
        rng_np = np.random.default_rng(seed)
        self.pool = device_pool(real_crops(gt_hw, 64 if big else 8, rng_np,
                                           paths), device)
        val = device_pool(real_crops(gt_hw, 8 if big else 2,
                                     np.random.default_rng(seed + 7),
                                     paths), device)
        degrade = realesrgan(scale)
        with torch.no_grad():
            self.lq_val, gt = degrade(
                torch.Generator(device).manual_seed(123), val)
            self.calib_lq, _ = degrade(
                torch.Generator(device).manual_seed(99), self.pool[:4])
        self.gt_val = gt.float().cpu().numpy()

    def train(self, quant, tag, weight_bits=8):
        model = build_sr_trainer(self.bs, gt_hw=self.gt_hw,
                                 num_feat=self.num_feat,
                                 num_conv=self.num_conv, quant=quant,
                                 lr=1e-3, weight_bits=weight_bits,
                                 device=self.device)
        gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        train_loop(model, self.pool, self.bs, self.total_iters, self.chunk,
                   gen, ("l_pix",), tag, lambda done, losses, _: log(
                       f"  {tag} iter {done}: loss "
                       f"{losses['l_pix'].mean():.4f}"))
        return model

    def psnr_vs_gt(self, out):
        out = np.clip(out.float().cpu().numpy(), 0, 1)
        return _span_psnr(self.gt_val, out)

    @torch.no_grad()
    def float_out(self, net):
        out = net(self.lq_val)
        return out[0] if isinstance(out, tuple) else out


def int8_engine(tmp, num_feat, num_conv, scale, device, net=None,
                calib=None, qat_model=None):
    """The served int8 engine (`serve/sr_engine.build_graph`, bf16 IO) of
    an SRVGG: PTQ of `net` calibrated on `calib` (a device batch), or the
    engine built from `qat_model`'s training checkpoint (its EMA weights at
    its learned scales). Checkpoints go to the directory `tmp`."""
    from ..serve.sr_engine import build_graph
    geo = dict(num_feat=num_feat, num_conv=num_conv, upscale=scale,
               io="bf16", device=device)
    if qat_model is not None:
        ckpt = os.path.join(tmp, "qat_ckpt.pth")
        torch.save(qat_model.training_state(), ckpt)
        graph, _ = build_graph(qat_ckpt=ckpt, **geo)
    else:
        pth = os.path.join(tmp, "ptq_net.pth")
        torch.save({"params": {k: v.detach().cpu() for k, v in
                               net.state_dict().items()}}, pth)
        graph, _ = build_graph(pth=pth, calib=calib.float().cpu().numpy(),
                               **geo)
    return torch.inference_mode()(graph)


def bench_qat_vs_ptq(total_iters=600, chunk=100, bs=8, num_feat=64,
                     num_conv=32, gt_hw=256, scale=4, seed=0, device=None,
                     paths=None):
    """Same init, same data stream: float-then-PTQ against QAT, each judged
    as the served int8 engine on the held-out pair. Returns JAX's record
    plus the K2 launches of each engine call (0 on the CPU)."""
    from ..ops.int8_conv import int8_conv3x3_requant as k2
    arms = _Arms(total_iters, chunk, bs, num_feat, num_conv, gt_hw, scale,
                 seed, device, paths)
    result = {"iters": total_iters, "bs": bs,
              "config": f"SRVGG {num_feat}f/{num_conv}c x{scale}, same "
                        "init + data stream, int8 through "
                        "serve/sr_engine.py",
              "val": "held-out crops, one fixed 2nd-order degradation"}
    calls = []
    geo = (num_feat, num_conv, scale, arms.device)

    def served(engine):
        before = k2.launches
        out = engine(arms.lq_val)
        calls.append(k2.launches - before)
        return arms.psnr_vs_gt(out)

    with tempfile.TemporaryDirectory(prefix="irt_qat_") as tmp:
        t0 = time.perf_counter()
        model_f = arms.train(False, "float")
        result["float_psnr"] = round(arms.psnr_vs_gt(
            arms.float_out(model_f.net_g_ema)), 3)
        result["ptq_int8_psnr"] = round(served(int8_engine(
            tmp, *geo, net=model_f.net_g_ema, calib=arms.calib_lq)), 3)
        result["float_arm_wall_s"] = round(time.perf_counter() - t0, 1)
        del model_f

        t0 = time.perf_counter()
        model_q = arms.train(True, "qat")
        result["qat_int8_psnr"] = round(served(int8_engine(
            tmp, *geo, qat_model=model_q)), 3)
        result["qat_float_psnr"] = round(arms.psnr_vs_gt(
            arms.float_out(model_q.net_g_ema)), 3)
        result["qat_arm_wall_s"] = round(time.perf_counter() - t0, 1)
    result["qat_minus_ptq_db"] = round(
        result["qat_int8_psnr"] - result["ptq_int8_psnr"], 3)
    result["k2_launches_per_engine_call"] = calls
    log(f"served int8 val PSNR: PTQ {result['ptq_int8_psnr']} dB vs QAT "
        f"{result['qat_int8_psnr']} dB (float arm {result['float_psnr']} "
        f"dB) — QAT-PTQ = {result['qat_minus_ptq_db']} dB; K2 {calls} "
        "per engine call")
    return result


def bench_w4a8(total_iters=600, chunk=100, bs=8, num_feat=64, num_conv=32,
               gt_hw=256, scale=4, seed=0, weight_bits=4, device=None,
               paths=None):
    """Sub-8-bit weights, where PTQ degrades: float training then
    `weight_bits` weight PTQ (calibrated activation scales) against QAT at
    that width, both judged through the fake-quant twin at
    weight_qmax = 2^(bits−1) − 1 (per output channel)."""
    from ..ops.qat import qat_srvgg_forward
    from ..ops.quantized_inference import calibrate_srvgg_act_scales

    qmax = 2 ** (weight_bits - 1) - 1
    tag = f"qat{weight_bits}"
    arms = _Arms(total_iters, chunk, bs, num_feat, num_conv, gt_hw, scale,
                 seed, device, paths)

    @torch.no_grad()
    def twin_out(net, qscale):
        return qat_srvgg_forward(net, arms.lq_val, qscale, qmax)[0]

    result = {"iters": total_iters, "bs": bs,
              "config": f"SRVGG {num_feat}f/{num_conv}c x{scale} "
                        f"w{weight_bits}a8 (weight_qmax={qmax} "
                        "per-channel), same init + data stream",
              "val": "held-out crops, one fixed 2nd-order degradation, "
                     f"judged through the exact w{weight_bits}a8 "
                     "fake-quant twin"}
    t0 = time.perf_counter()
    model_f = arms.train(False, "float", weight_bits)
    scales = calibrate_srvgg_act_scales(model_f.net_g_ema, arms.calib_lq)
    result["float_psnr"] = round(arms.psnr_vs_gt(
        arms.float_out(model_f.net_g_ema)), 3)
    result["ptq_w4a8_psnr"] = round(arms.psnr_vs_gt(
        twin_out(model_f.net_g_ema, scales)), 3)
    result["float_arm_wall_s"] = round(time.perf_counter() - t0, 1)
    del model_f

    t0 = time.perf_counter()
    model_q = arms.train(True, tag, weight_bits)
    result["qat_w4a8_psnr"] = round(arms.psnr_vs_gt(
        twin_out(model_q.net_g_ema, model_q.qscale)), 3)
    result["qat_arm_wall_s"] = round(time.perf_counter() - t0, 1)
    result["qat_minus_ptq_db"] = round(
        result["qat_w4a8_psnr"] - result["ptq_w4a8_psnr"], 3)
    log(f"w{weight_bits}a8 val PSNR: PTQ {result['ptq_w4a8_psnr']} dB vs "
        f"QAT {result['qat_w4a8_psnr']} dB (float {result['float_psnr']} "
        f"dB) — QAT-PTQ = {result['qat_minus_ptq_db']:+} dB")
    return result


def distill_options(num_feat, num_conv, teacher_blocks, gt_hw, scale):
    """DistillModel options: the bf16 RRDB teacher (random weights: a step's
    cost does not depend on them) inside the SRVGG student's step."""
    return {
        "is_train": True, "manual_seed": 0, "num_devices": 1,
        "scale": scale, "gt_size": gt_hw,
        "path": {"models": os.path.join(EXP, "models")},
        "logger": {},
        "model_type": "DistillModel",
        "network_g": dict(type="SRVGGNetCompact", num_feat=num_feat,
                          num_conv=num_conv, upscale=scale),
        "network_t": dict(type="RRDBNet", scale=scale, num_feat=64,
                          num_block=teacher_blocks,
                          dtype="bf16" if teacher_blocks > 1 else None),
        "train": {
            "optim_g": {"type": "Adam", "lr": 2e-4},
            "scheduler": {"type": "MultiStepLR",
                          "milestones": [400000], "gamma": 0.5},
            "total_iter": 400000, "ema_decay": 0.999,
            "allow_random_teacher": True,
            "distill_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
        },
    }


def bench_distill_step(batch_sizes=(8, 16), iters=8, num_feat=64,
                       num_conv=32, teacher_blocks=23, gt_hw=256, scale=4,
                       device=None, paths=None):
    """The production-shape distillation step's cost at each batch size."""
    from ..models import build_model
    rows = []
    rng_np = np.random.default_rng(0)
    for bs in batch_sizes:
        model = build_model(distill_options(num_feat, num_conv,
                                            teacher_blocks, gt_hw, scale),
                            device=device)
        model.set_degradation_pipeline(realesrgan(scale))
        pool = device_pool(real_crops(gt_hw, bs * 2, rng_np, paths), device)
        sec = time_steps(model, pool, bs, iters, device)
        rows.append({"bs": bs, "ms_per_step": round(sec * 1e3, 2),
                     "imgs_per_sec": round(bs / sec, 1)})
        log(f"Distill step (RRDB-{teacher_blocks} bf16 teacher -> SRVGG "
            f"student) bs={bs}: {sec * 1e3:.1f} ms/step = "
            f"{bs / sec:.1f} imgs/s")
        del model
    return {"config": f"RRDB-{teacher_blocks} bf16 teacher fwd + SRVGG "
                      f"{num_feat}f/{num_conv}c student step, gt {gt_hw}²",
            "rows": rows}


def run(tiny=False, device=None, gt_dir=None):
    """Every section at the JAX script's sizes (its --tiny ones with
    tiny)."""
    from ..utils.device import resolve_device
    device = resolve_device("cpu" if tiny and device is None else device)
    paths = photo_paths(gt_dir)
    out = {"date": time.strftime("%Y-%m-%d"),
           "timing": f"eager steps on {device}, host clock over the steps "
                     f"ending in one synchronize, least of {REPEATS} runs"}
    if tiny:
        small = dict(num_feat=8, num_conv=2, gt_hw=64, device=device,
                     paths=paths)
        arms = dict(total_iters=6, chunk=3, bs=2, **small)
        out["qat_step"] = bench_qat_step(bs=2, iters=2, **small)
        out["qat_vs_ptq"] = bench_qat_vs_ptq(**arms)
        out["qat4_vs_ptq4"] = bench_w4a8(**arms)
        out["qat2_vs_ptq2"] = bench_w4a8(weight_bits=2, **arms)
        out["distill_step"] = bench_distill_step(
            batch_sizes=(2,), iters=2, teacher_blocks=1, **small)
    else:
        full = dict(device=device, paths=paths)
        out["qat_step"] = bench_qat_step(**full)
        out["qat_vs_ptq"] = bench_qat_vs_ptq(**full)
        out["qat4_vs_ptq4"] = bench_w4a8(**full)
        out["qat2_vs_ptq2"] = bench_w4a8(weight_bits=2, **full)
        out["distill_step"] = bench_distill_step(**full)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="8f/2c nets at 64², 6 iterations an arm, on the "
                         "CPU")
    ap.add_argument("--gt-dir", default=None,
                    help="photos to crop the GT from (default: seeded "
                         "synthetic plate scenes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(EXP, "qat_distill.json"))
    args = ap.parse_args(argv)
    out = run(args.tiny, args.device, args.gt_dir)
    write_report(out, args.out)
    print(json.dumps({"metric": "qat_minus_ptq_db",
                      "w8a8": out["qat_vs_ptq"]["qat_minus_ptq_db"],
                      "w4a8": out["qat4_vs_ptq4"]["qat_minus_ptq_db"],
                      "w2a8": out["qat2_vs_ptq2"]["qat_minus_ptq_db"],
                      "unit": "dB_val"}), flush=True)
    return out


if __name__ == "__main__":
    main()
