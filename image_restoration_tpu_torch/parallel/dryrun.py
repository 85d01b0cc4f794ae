"""Multi-device dry run: the three parts of JAX's `dryrun_multichip`.

Counterpart of `__graft_entry__.py:42-200` on `torch.distributed`.
`dryrun_multichip(n)` starts n processes (gloo on the CPU; `backend=
"nccl"` puts rank r on cuda:r), joined at a free localhost port, and each
rank runs, at JAX's sizes:

  1. one step of the real GFPGAN trainer (`GFPGANModel`: the FFHQ
     degradation on the device, G with its pyramid, the pixel, pyramid and
     GAN losses, the G update and EMA, the D update) and its R1 step, on a
     global batch of 2n 32² images split over the world (GFPGANv1OCR 32²,
     `num_style_feat` 16, `channel_multiplier` 0.25);
  2. the tiled serving forward of an SRVGG ×4 through
     `spatial_sharded_apply` (8 rows a rank, halo 5), its interior held
     against the unsharded forward to 1e-4;
  3. one data-parallel detector step (mobilenet0.25 at 64², a global
     batch of 2n synthetic scenes).

It raises if any process fails. Run it as

    python -m image_restoration_tpu_torch.parallel.dryrun 2 [--backend nccl]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gan_options(n: int, root: str) -> dict:
    """JAX's dry-run trainer options (`__graft_entry__.py:101-140`) for a
    world of n, writing under `root`."""
    return {
        "is_train": True, "manual_seed": 0, "num_devices": n, "scale": 1,
        "path": {"models": os.path.join(root, "models"),
                 "visualization": os.path.join(root, "vis")},
        "logger": {"print_freq": 1},
        "model_type": "GFPGANModel",
        "network_g": dict(type="GFPGANv1OCR", input_width=32,
                          input_height=32, num_style_feat=16,
                          channel_multiplier=0.25, num_mlp=2,
                          input_is_latent=True, different_w=True,
                          narrow=0.5, sft_half=True, fix_decoder=False),
        "network_d": dict(type="StyleGAN2Discriminator", input_width=32,
                          input_height=32, channel_multiplier=0.25,
                          narrow=0.25),
        "train": {
            "optim_g": {"type": "Adam", "lr": 2e-3},
            "optim_d": {"type": "Adam", "lr": 2e-3},
            "scheduler": {"type": "MultiStepLR", "milestones": [100],
                          "gamma": 0.5},
            "total_iter": 2,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
            "L1_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                        "loss_weight": 0.1},
            "pyramid_loss_weight": 1.0, "remove_pyramid_loss": 100,
            "r1_reg_weight": 10, "net_d_iters": 1, "net_d_init_iters": 0,
            "net_d_reg_every": 1,  # the R1 step runs in the dry run
        },
    }


def gan_degradation():
    from ..data.pipelines import FFHQDegradationConfig, make_ffhq_degradation
    return make_ffhq_degradation(FFHQDegradationConfig(
        kernel_list=("iso", "aniso"), kernel_prob=(0.5, 0.5),
        downsample_range=(2.0, 4.0)))


def run_rank(device, root: str) -> None:
    """The three parts on this rank of the world that is up."""
    import torch

    from ..archs import build_network
    from ..detect.synth import make_batch
    from ..detect.train import DetectorTrainer
    from ..models import build_model
    from ..utils.dist_util import get_dist_info
    from .spatial import spatial_sharded_apply

    rank, n = get_dist_info()
    say = print if rank == 0 else (lambda *a, **k: None)

    # 1/3: one GFPGAN GAN step and its R1 step, the batch split over ranks
    model = build_model(gan_options(n, root), device=device)
    model.set_degradation_pipeline(gan_degradation())
    gt = np.random.default_rng(0).random((2 * n, 32, 32, 3), np.float32)
    model.optimize_parameters(1, {"gt": gt[2 * rank:2 * rank + 2]})
    logs = model.log_dict  # the world's means
    for k, v in logs.items():
        assert np.isfinite(v), f"non-finite {k} in the dry run"
    assert "l_d_r1" in logs, "the R1 step did not run"
    say(f"dryrun_multichip({n}): GAN step + R1 over a world of {n}, "
        f"losses={ {k: round(v, 4) for k, v in logs.items()} } OK")

    # 2/3: the tiled serving forward, rows sharded with halo exchange
    srvgg = build_network(dict(type="SRVGGNetCompact", num_feat=8,
                               num_conv=2, upscale=4),
                          torch.Generator().manual_seed(1)).to(device).eval()
    img = torch.from_numpy(np.random.default_rng(1).random(
        (1, 8 * n, 16, 3), np.float32)).to(device)
    halo = 2 * 2 + 1
    with torch.no_grad():
        sharded = spatial_sharded_apply(srvgg, img, halo=halo, scale=4)
        full = srvgg(img)
    inner = slice(4 * halo, -4 * halo)
    err = float((sharded[:, inner] - full[:, inner]).abs().max())
    assert err < 1e-4, f"tiled-serving interior mismatch: {err}"
    say(f"dryrun_multichip({n}): tiled serving with halo exchange over "
        f"{n} ranks, interior max|d|={err:.2e} OK")

    # 3/3: one data-parallel detector step
    trainer = DetectorTrainer(backbone="mobilenet0.25", image_size=64,
                              lr=1e-3, data_parallel=n, device=device)
    imgs, targets = make_batch(torch.Generator().manual_seed(2), 2 * n, 64)
    det = trainer.train_step(imgs, targets)
    for k, v in det.items():
        assert bool(torch.isfinite(v)), f"non-finite detector {k}"
    say(f"dryrun_multichip({n}): detector step over {n} ranks, losses="
        f"{ {k: round(float(v), 4) for k, v in det.items()} } OK")


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     timeout: float = 900.0) -> None:
    """Run the three parts in a world of `n_devices` processes; raises if
    any of them fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as root:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "image_restoration_tpu_torch.parallel."
             "dryrun", str(n_devices), "--rank", str(r), "--port", str(port),
             "--backend", backend, "--root", root], env=env)
            for r in range(n_devices)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: exit "
                           f"codes {rcs}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--rank", type=int, default=None,
                    help="(a child process: its rank)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n, args.backend)
        return
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    device = "cpu"
    if args.backend == "nccl":
        torch.cuda.set_device(args.rank)
        device = f"cuda:{args.rank}"
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{args.port}",
                            rank=args.rank, world_size=args.n)
    try:
        run_rank(device, args.root)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
