"""Training convergence: loss down and held-out PSNR up, for the ×4 SR
trainer and the production GFPGAN GAN trainer, at full width on the card.

Port of the repo-root `scripts/bench_train.py --convergence` and of the
pieces of that script the other training-evidence scripts share:

  * `build_gfpgan_trainer` / `build_sr_trainer`: JAX's option dicts
    (`gfpgan_trainer_options`, `sr_trainer_options` give them without
    building a net) through the port's `build_model`, with the degradation
    on the device (the production FFHQ chain; the second-order Real-ESRGAN
    chain);
  * `real_crops`: 256² GT crops of photos, or, with no photos, seeded
    synthetic plate scenes from `detect/synth.py` (JAX falls back to
    uniform noise, which no restorer can learn);
  * `train_chunk`: JAX's `lax.scan` chunk as an eager loop: the GT batch
    rotates through the pool from its start each chunk, R1 every 16 at the
    global iteration, every draw from one `torch.Generator`, and the
    losses stay on the device until the chunk ends (one host read);
  * `train_loop`: chunks until the iterations or a wall budget run out,
    each chunk's losses checked finite, then the script's own records;
  * `FixedVal`: one fixed degradation of the held-out crops, scored on the
    EMA and the live head after each chunk.

    python -m image_restoration_tpu_torch.scripts.train_convergence \\
        --convergence --conv-model sr [--conv-iters 300] [--conv-bs 8] \\
        [--conv-dtype f32] [--gt-dir photos/] [--out report.json]
    python -m image_restoration_tpu_torch.scripts.train_convergence \\
        --conv-model gfpgan --tiny   # tiny nets at 32-64², on the CPU

`--convergence` is the only mode: the step-timing modes of `bench_train.py`
belong to the benchmark.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

EXP = os.path.join("experiments", "train_convergence")
PHOTO_GLOB = ("*.jpg", "*.jpeg", "*.png")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def torch_dtype(name):
    """"bf16" → torch.bfloat16, "f32" (or None) → None: the nets' dtype."""
    return {"bf16": torch.bfloat16, "f32": None, None: None}[name]


# --------------------------------------------------------------- builders

def gfpgan_trainer_options(batch, dtype=None, perceptual=True, remat=False,
                           img_hw=256, gan_weight=0.1, tiny_net=False,
                           total_iter=200000, milestones=(100000, 150000),
                           remove_pyramid_loss=50000, grad_clip=None):
    """(options, degradation config kwargs) of the production GFPGANModel
    at `img_hw`² (configs/train_gfpgan_plate_256.yml's recipe).

    gan_weight=0.0 with perceptual=False is the pure-pixel ablation arm:
    the step graph is unchanged (D still trains, R1 too), but G's gradient
    carries only the pixel and pyramid losses. tiny_net=True takes the
    small CPU shapes. dtype (torch.bfloat16 or None) is the nets'; a bf16
    trainer also runs the VGG taps in bf16 and caps the median/bilateral
    filters to 6 slots of the batch."""
    clip = {"grad_clip": float(grad_clip)} if grad_clip else {}
    train = {
        "optim_g": {"type": "Adam", "lr": 2e-3, **clip},
        "optim_d": {"type": "Adam", "lr": 2e-3, **clip},
        "scheduler": {"type": "MultiStepLR", "milestones": list(milestones),
                      "gamma": 0.5},
        "total_iter": total_iter,
        "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
        "L1_opt": {"type": "L1Loss", "loss_weight": 1.0},
        "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                    "loss_weight": gan_weight},
        "pyramid_loss_weight": 1.0,
        "remove_pyramid_loss": remove_pyramid_loss,
        "r1_reg_weight": 10,
        "net_d_iters": 1, "net_d_init_iters": 0, "net_d_reg_every": 16,
        "remat": remat,
    }
    if perceptual:
        train["perceptual_opt"] = {
            "type": "PerceptualLoss",
            "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                              "conv4_4": 1, "conv5_4": 1},
            "vgg_type": "vgg19", "use_input_norm": True,
            "perceptual_weight": 1.0, "style_weight": 50,
            "range_norm": True, "criterion": "l1"}
        if dtype is not None:
            train["perceptual_opt"]["compute_dtype"] = "bf16"
    opt = {
        "is_train": True, "manual_seed": 0, "num_devices": 1, "scale": 1,
        "path": {"models": os.path.join(EXP, "models"),
                 "visualization": os.path.join(EXP, "vis")},
        "logger": {"print_freq": 100},
        "model_type": "GFPGANModel",
        "network_g": dict(type="GFPGANv1OCR", input_width=img_hw,
                          input_height=img_hw,
                          num_style_feat=16 if tiny_net else 256,
                          channel_multiplier=0.25 if tiny_net else 0.5,
                          num_mlp=2 if tiny_net else 4,
                          input_is_latent=True, different_w=True,
                          narrow=0.5 if tiny_net else 1,
                          sft_half=True, fix_decoder=False, dtype=dtype),
        "network_d": dict(type="StyleGAN2Discriminator", input_width=img_hw,
                          input_height=img_hw,
                          channel_multiplier=0.25 if tiny_net else 1,
                          **({"narrow": 0.25} if tiny_net else {}),
                          dtype=dtype),
        "train": train,
    }
    deg = dict(nonlinear_slots=6 if dtype is not None else None)
    if tiny_net:
        deg.update(kernel_list=("iso", "aniso"), kernel_prob=(0.5, 0.5),
                   downsample_range=(2.0, 4.0))
    return opt, deg


def build_gfpgan_trainer(batch, dtype=None, perceptual=True, remat=False,
                         img_hw=256, gan_weight=0.1, tiny_net=False,
                         total_iter=200000, milestones=(100000, 150000),
                         remove_pyramid_loss=50000, grad_clip=None,
                         device=None):
    """The GFPGANModel of `gfpgan_trainer_options` on `device` (None: cuda)
    with its FFHQ degradation, ready for `train_chunk`."""
    from ..data.pipelines import FFHQDegradationConfig, make_ffhq_degradation
    from ..models import build_model

    opt, deg = gfpgan_trainer_options(
        batch, dtype, perceptual, remat, img_hw, gan_weight, tiny_net,
        total_iter, milestones, remove_pyramid_loss, grad_clip)
    model = build_model(opt, device=device)
    model.set_degradation_pipeline(
        make_ffhq_degradation(FFHQDegradationConfig(**deg)))
    # JAX's scan loops pass update_g=True on every step, iteration 0
    # included; the port's step skips G while iter <= net_d_init_iters
    model.net_d_init_iters = -1
    return model


def sr_trainer_options(batch, dtype=None, scale=4, gt_hw=256, num_feat=64,
                       num_conv=32, quant=False, lr=2e-4, weight_bits=8):
    """(options, degradation config kwargs) of the SRVGG ×4 L1 SRModel
    under the second-order Real-ESRGAN chain. quant=True adds
    train.quant_opt (QAT against the fake-quant twin of the int8 serving
    graph, `weight_bits` wide weights)."""
    opt = {
        "is_train": True, "manual_seed": 0, "num_devices": 1,
        "scale": scale, "gt_size": gt_hw,
        "path": {"models": os.path.join(EXP, "models"),
                 "visualization": os.path.join(EXP, "vis")},
        "logger": {"print_freq": 100},
        "model_type": "SRModel",
        "network_g": dict(type="SRVGGNetCompact", num_feat=num_feat,
                          num_conv=num_conv, upscale=scale, dtype=dtype),
        "train": {
            "optim_g": {"type": "Adam", "lr": lr},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000],
                          "gamma": 0.5},
            "total_iter": 400000,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "ema_decay": 0.999,
            **({"quant_opt": {"weight_bits": weight_bits}}
               if quant else {}),
        },
    }
    return opt, dict(scale=scale)


def build_sr_trainer(batch, dtype=None, scale=4, gt_hw=256, num_feat=64,
                     num_conv=32, quant=False, lr=2e-4, weight_bits=8,
                     device=None):
    """The SRModel of `sr_trainer_options` on `device` with its Real-ESRGAN
    degradation."""
    from ..models import build_model

    opt, deg = sr_trainer_options(batch, dtype, scale, gt_hw, num_feat,
                                  num_conv, quant, lr, weight_bits)
    model = build_model(opt, device=device)
    model.set_degradation_pipeline(realesrgan(**deg))
    return model


def realesrgan(scale=4):
    from ..data.pipelines import (RealESRGANDegradationConfig,
                                  make_realesrgan_degradation)
    return make_realesrgan_degradation(RealESRGANDegradationConfig(
        scale=scale))


# ------------------------------------------------------------------ data

def synthetic_crops(size, n, seed):
    """n seeded synthetic plate scenes of size², RGB float32 [0, 1]
    (`detect/synth.py`, drawn on the CPU, so equal on every device)."""
    from ..detect.synth import make_batch
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        imgs, _ = make_batch(gen, n, size)
    return (imgs.numpy()[..., ::-1] / 255.0).astype(np.float32)


def photo_paths(gt_dir):
    """The photos of `gt_dir`, sorted (none when gt_dir is None)."""
    if not gt_dir:
        return []
    return sorted(p for pat in PHOTO_GLOB
                  for p in glob.glob(os.path.join(gt_dir, pat)))


def real_crops(size, n, rng, paths=None):
    """n GT crops of size² (RGB float32 [0, 1]) at positions from the numpy
    generator `rng`, cycling over the photos `paths`; with no photos,
    `synthetic_crops` seeded from `rng`."""
    import cv2
    if not paths:
        return synthetic_crops(size, n, rng.integers(0, 2 ** 31))
    crops = []
    while len(crops) < n:
        for p in paths:
            img = cv2.imread(p)[..., ::-1].astype(np.float32) / 255.0
            ih, iw = img.shape[:2]
            if ih < size or iw < size:
                img = cv2.resize(img, (max(size, iw), max(size, ih)))
                ih, iw = img.shape[:2]
            y = rng.integers(0, ih - size + 1)
            x = rng.integers(0, iw - size + 1)
            crops.append(img[y:y + size, x:x + size])
            if len(crops) >= n:
                break
    return np.stack(crops)


def data_note(paths):
    if paths:
        return f"{len(paths)} photos, 256² crops (real content)"
    return ("seeded synthetic plate scenes (detect/synth.py); no photos "
            "given (--gt-dir)")


# ------------------------------------------------------------ the loops

def train_chunk(model, pool, bs, iters, generator, keys,
                record_schedule=False):
    """`iters` training steps of `model` (a GFPGANModel or an SRModel) on
    batches of `pool` (a device tensor), as JAX's scan chunk: batch i of
    the chunk starts at row (i·bs) mod n (clamped so it fits); the GAN's R1
    falls on the global iterations divisible by 16. `generator` draws the
    degradation and the noise. Returns {key: float32 array (iters,)} of
    the losses named in `keys` (0 where a step has none), read from the
    device once, at the end; with record_schedule, also the pyramid weight
    and the G lr each step used, under "pyr_w" and "lr_g"."""
    n = pool.shape[0]
    rows = {k: [] for k in keys}
    zero = torch.zeros((), device=pool.device)
    pyr, lrs = [], []
    for i in range(iters):
        start = min((i * bs) % n, n - bs)
        it = model.iter
        if record_schedule:
            pyr.append(model.pyramid_weight(it))
            lrs.append(model.optimizer_g.schedule(model.optimizer_g.count))
        losses = model.optimize_parameters(
            it, {"gt": pool[start:start + bs]}, generator)
        for k in keys:
            rows[k].append(losses.get(k, zero).float())
    out = torch.stack([torch.stack(v) for v in rows.values()]).cpu().numpy()
    res = {k: out[j] for j, k in enumerate(keys)}
    if record_schedule:
        res["pyr_w"] = np.asarray(pyr, np.float64)
        res["lr_g"] = np.asarray(lrs, np.float64)
    return res


class FixedVal:
    """One fixed degradation of the held-out crops (a generator seeded
    `seed`, drawn once), and the PSNR of a head on it: the output clipped
    to `min_max`, peak the span."""

    def __init__(self, degrade_fn, imgs, min_max, seed=123):
        gen = torch.Generator(imgs.device).manual_seed(seed)
        with torch.no_grad():
            self.lq, self.gt = degrade_fn(gen, imgs)
        self.min_max = min_max

    @torch.no_grad()
    def out(self, net, gfpgan):
        o = net(self.lq, return_rgb=False, randomize_noise=False) if gfpgan \
            else net(self.lq)
        o = o[0] if isinstance(o, tuple) else o
        return torch.clamp(o.float(), *self.min_max)

    def psnr_of(self, out):
        span = self.min_max[1] - self.min_max[0]
        mse = torch.mean((out - self.gt.float()) ** 2)
        return float(10 * torch.log10(span ** 2 / torch.clamp(mse, 1e-20)))

    def psnr(self, net, gfpgan):
        return self.psnr_of(self.out(net, gfpgan))


def device_pool(arr, device):
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32,
                           device=device)


def train_loop(model, pool, bs, total_iters, chunk, generator, keys, label,
               after_chunk=None, budget_s=None, done=0,
               record_schedule=False):
    """JAX's chunked scan loop, eagerly: `train_chunk`s of `chunk`
    iterations from iteration `done` until `total_iters`, each chunk's
    losses `keys` checked finite, then `after_chunk(done, losses, seconds)`
    for what the script records. With budget_s, a chunk that would cross
    the wall budget (at the least chunk time so far) is not started.
    Returns the iterations done."""
    t_start, cost = time.perf_counter(), None
    while done < total_iters:
        if budget_s is not None and cost is not None and \
                time.perf_counter() - t_start + cost > budget_s:
            log(f"  {label}: wall budget {budget_s:.0f}s reached at iter "
                f"{done} (a chunk costs {cost:.1f}s)")
            break
        t0 = time.perf_counter()
        losses = train_chunk(model, pool, bs, chunk, generator, keys,
                             record_schedule)
        bad = [k for k in keys if not np.all(np.isfinite(losses[k]))]
        if bad:
            raise FloatingPointError(f"{label}: non-finite {bad} in the "
                                     f"chunk from iter {done}")
        done += chunk
        dt = time.perf_counter() - t0
        cost = dt if cost is None else min(cost, dt)
        if after_chunk is not None:
            after_chunk(done, losses, dt)
    return done


# ----------------------------------------------------------- convergence

def convergence(model_kind="sr", total_iters=300, chunk=25, bs=8,
                dtype="f32", seed=0, device=None, gt_dir=None, tiny=False):
    """Train from scratch on GT crops and score both heads on one fixed
    degradation of 8 held-out crops after every chunk (the EMA head alone
    at iteration 0). Returns JAX's report: the curve of iterations, the
    chunk's mean loss and the two PSNRs."""
    from ..utils.device import resolve_device
    device = resolve_device(device)
    hw, n_pool, n_val = ((32 if model_kind == "gfpgan" else 64, 8, 2)
                         if tiny else (256, 64, 8))
    paths = photo_paths(gt_dir)
    rng_np = np.random.default_rng(seed)
    pool = device_pool(real_crops(hw, n_pool, rng_np, paths), device)
    val_imgs = device_pool(real_crops(hw, n_val, rng_np, paths), device)

    gfpgan = model_kind == "gfpgan"
    if gfpgan:
        model = build_gfpgan_trainer(bs, dtype=torch_dtype(dtype),
                                     img_hw=hw, tiny_net=tiny, device=device)
        min_max, key = (-1.0, 1.0), "l_g_pix"
    else:
        model = build_sr_trainer(bs, dtype=torch_dtype(dtype), gt_hw=hw,
                                 device=device,
                                 **(dict(num_feat=8, num_conv=2) if tiny
                                    else {}))
        min_max, key = (0.0, 1.0), "l_pix"
    val = FixedVal(model.degrade_fn, val_imgs, min_max)

    curve = {"iters": [], "loss": [], "val_psnr": [], "val_psnr_live": []}
    p0 = val.psnr(model.net_g_ema, gfpgan)
    curve["iters"].append(0)
    curve["loss"].append(None)
    curve["val_psnr"].append(round(p0, 3))
    curve["val_psnr_live"].append(round(p0, 3))
    log(f"{model_kind} convergence: iter 0 val PSNR {p0:.2f} dB")

    def record(done, losses, _):
        loss = float(losses[key].mean())
        p = val.psnr(model.net_g_ema, gfpgan)
        p_live = val.psnr(model.net_g, gfpgan)
        curve["iters"].append(done)
        curve["loss"].append(round(loss, 5))
        curve["val_psnr"].append(round(p, 3))
        curve["val_psnr_live"].append(round(p_live, 3))
        log(f"  iter {done:4d}: loss {loss:.4f} val PSNR {p:.2f} dB (ema) / "
            f"{p_live:.2f} dB (live)")

    gen = torch.Generator(device).manual_seed(seed + 1)
    t0 = time.perf_counter()
    train_loop(model, pool, bs, total_iters, min(chunk, total_iters), gen,
               (key,), model_kind, record)
    wall = time.perf_counter() - t0
    result = {
        "model": model_kind, "bs": bs, "dtype": dtype,
        "total_iters": total_iters,
        "wall_seconds": round(wall, 1),
        "data": data_note(paths),
        "curve": curve,
        "date": time.strftime("%Y-%m-%d"),
    }
    if gfpgan:
        result["note"] = (f"GFPGANv1OCR {hw}² with StyleGAN2Discriminator "
                          f"on {device}; the EMA head (decay 0.5^(32/10⁴)) "
                          "lags the live head at short horizons")
    return result


def better_gain(curve, ema="val_psnr", live="val_psnr_live"):
    """The better head's final PSNR minus iteration 0's."""
    return max(curve[ema][-1], curve[live][-1]) - curve[ema][0]


def write_report(report, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    log(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--convergence", action="store_true",
                    help="the only mode (accepted for the JAX command line)")
    ap.add_argument("--conv-model", default="sr", choices=["sr", "gfpgan"])
    ap.add_argument("--conv-iters", type=int, default=300)
    ap.add_argument("--conv-bs", type=int, default=8)
    ap.add_argument("--conv-dtype", default="f32", choices=["bf16", "f32"])
    ap.add_argument("--gt-dir", default=None,
                    help="photos to crop the GT from (default: seeded "
                         "synthetic plate scenes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="the report (default "
                    "experiments/train_convergence/train_convergence_"
                    "{model}.json)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny nets (GFPGAN at 32², SR at 64²), 6 iterations "
                         "of batch 2 in chunks of 3, on the CPU (flags given "
                         "explicitly still apply)")
    args = ap.parse_args(argv)
    if args.tiny:
        for k, v in dict(conv_iters=6, conv_bs=2, device="cpu").items():
            if getattr(args, k) == ap.get_default(k):
                setattr(args, k, v)
    report = convergence(args.conv_model, args.conv_iters,
                         3 if args.tiny else 25, args.conv_bs,
                         dtype=args.conv_dtype, device=args.device,
                         gt_dir=args.gt_dir, tiny=args.tiny)
    write_report(report, args.out or os.path.join(
        EXP, f"train_convergence_{args.conv_model}.json"))
    print(json.dumps({"metric": "val_psnr_gain_db",
                      "value": round(better_gain(report["curve"]), 3),
                      "model": args.conv_model,
                      "iters": args.conv_iters}), flush=True)
    return report


if __name__ == "__main__":
    main()
