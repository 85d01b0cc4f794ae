"""FID of a StyleGAN2 generator against dataset statistics.

Port of `scripts/metrics/calculate_stylegan2_fid.py`: the generator
(`StyleGAN2OCRGenerator` at `--size`², 512 style features, 8 MLP layers,
`--channel_multiplier`) takes `params_ema` from a `net_g_*.pth` through the
port's `convert/pth.py`, samples `--num_sample` images in batches of
`--batch_size` at `--truncation` around the mean latent of
`--truncation_mean` codes, without noise; each batch is mapped from
[-1, 1] to [0, 1] and goes through InceptionV3 on the device, whose own
input resize takes it to 299² (JAX resizes in the script and again in the
net, an identity the second time), and the Fréchet distance of the features' statistics to those of
`fid_stats` (an `.npz`, or a reference `.pth`, with `mean` and `cov`) is
printed.

Codes come from `torch.Generator`s on the device: seed 1 for the mean
latent, 100 + i for batch i. The mean latent runs the style MLP alone
(`mean_latent`); JAX runs the whole generator over those codes and keeps
the latents, which XLA prunes and eager PyTorch would not.

    python -m image_restoration_tpu_torch.scripts.calculate_stylegan2_fid \\
        net_g_800000.pth inception_FFHQ_256.npz [--size 256] \\
        [--channel_multiplier 2] [--batch_size 16] [--num_sample 50000] \\
        [--truncation 1] [--truncation_mean 4096] \\
        [--inception_weights pt_inception.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..metrics.fid import (calculate_fid, extract_inception_features,
                           load_patched_inception_v3)
from ..utils.device import resolve_device

NUM_STYLE_FEAT = 512


def build_generator(ckpt: str, size: int, channel_multiplier: float,
                    device) -> torch.nn.Module:
    """The EMA generator of `ckpt` (`params_ema`, else `params`) on
    `device`, in eval form."""
    from ..archs import build_network
    from ..convert.pth import load_pth
    net = build_network(dict(type="StyleGAN2OCRGenerator", input_width=size,
                             input_height=size,
                             num_style_feat=NUM_STYLE_FEAT, num_mlp=8,
                             channel_multiplier=channel_multiplier))
    net.load_state_dict(load_pth(ckpt, "params_ema"), strict=True)
    return net.to(device).eval().requires_grad_(False)


def sample(net, z, truncation=1.0, truncation_latent=None) -> torch.Tensor:
    """One batch of samples for Inception: the generator's images without
    noise, mapped from [-1, 1] to [0, 1] (NHWC, at the generator's size)."""
    img = net([z], truncation=truncation,
              truncation_latent=truncation_latent, randomize_noise=False)[0]
    return torch.clamp((img + 1) / 2, 0, 1)


def load_stats(path: str):
    """(mean, cov) of an `.npz`, or of a reference stats `.pth` (a pickled
    dict whose arrays are numpy's, so it is read with `weights_only=False`:
    load only files you trust)."""
    if path.endswith(".npz"):
        with np.load(path) as stats:
            return stats["mean"], stats["cov"]
    stats = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(stats["mean"]), np.asarray(stats["cov"])


def main(argv=None) -> float:
    """Run the CLI; returns the FID."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help="net_g_*.pth with params_ema")
    p.add_argument("fid_stats", help=".npz (or reference .pth) dataset "
                                     "statistics")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_sample", type=int, default=50000)
    p.add_argument("--truncation", type=float, default=1)
    p.add_argument("--truncation_mean", type=int, default=4096)
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    net = build_generator(args.ckpt, args.size, args.channel_multiplier, dev)
    trunc_latent = None
    with torch.inference_mode():
        if args.truncation < 1:
            trunc_latent = net.mean_latent(
                args.truncation_mean,
                torch.Generator(dev).manual_seed(1))
    total_batch = math.ceil(args.num_sample / args.batch_size)

    def gen():
        for i in range(total_batch):
            z = torch.randn((args.batch_size, NUM_STYLE_FEAT), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                100 + i))
            yield sample(net, z, args.truncation, trunc_latent)

    extract = load_patched_inception_v3(args.inception_weights, device=dev)
    features = extract_inception_features(gen(), extract)[:args.num_sample]
    sample_mean = np.mean(features, 0)
    sample_cov = np.cov(features, rowvar=False)
    real_mean, real_cov = load_stats(args.fid_stats)
    fid = calculate_fid(sample_mean, sample_cov, real_mean, real_cov)
    print(f"fid: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
