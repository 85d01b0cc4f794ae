"""InceptionV3 statistics of a registered dataset, for FID.

Port of `scripts/metrics/calculate_fid_stats_from_datasets.py`: the dataset
(`FFHQDataset` by default, over `--io_backend disk|lmdb|pak`) is read
without flips through the port's `DataLoader`, its first `--num_sample`
images go through InceptionV3 on the device, and the mean and covariance
of their features are saved as an `.npz` (`mean`, `cov`, `name`, `size`)
that `calculate_stylegan2_fid` and `calculate_fid_folder` read.

The dataset returns GT normalized by mean and std; it is mapped back to
RGB in [0, 1] before Inception, the scale the sample path
(`calculate_stylegan2_fid`) and the folder path feed it. JAX's script hands
Inception the normalized [-1, 1] GT while its sample path feeds [0, 1], so
its statistics and its samples are scored across two scalings.

    python -m image_restoration_tpu_torch.scripts.calculate_fid_stats_from_datasets \\
        --dataroot datasets/ffhq/ffhq_256.lmdb --io_backend lmdb --size 256 \\
        [--num_sample 50000] [--batch_size 64] [--save_path x.npz] \\
        [--inception_weights pt_inception.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..data import DataLoader, build_dataset
from ..metrics.fid import extract_inception_features, load_patched_inception_v3
from ..utils.device import resolve_device


def dataset_batches(loader, total_batch: int, mean, std, device):
    """The loader's first `total_batch` GT batches on `device`, mapped from
    (x − mean)/std back to RGB in [0, 1]."""
    mean = torch.tensor(mean, dtype=torch.float32, device=device)
    std = torch.tensor(std, dtype=torch.float32, device=device)
    for idx, data in enumerate(loader):
        if idx >= total_batch:
            break
        yield torch.from_numpy(data["gt"]).to(device) * std + mean


def main(argv=None) -> str:
    """Run the CLI; returns the path of the saved statistics."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_sample", type=int, default=50000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--dataroot", type=str, default="datasets/ffhq")
    p.add_argument("--dataset_type", type=str, default="FFHQDataset")
    p.add_argument("--io_backend", type=str, default="disk",
                   choices=("disk", "lmdb", "pak"))
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--save_path", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    opt = {
        "name": "FFHQ",
        "type": args.dataset_type,
        "dataroot_gt": args.dataroot,
        "io_backend": {"type": args.io_backend},
        "use_hflip": False,
        "mean": [0.5, 0.5, 0.5],
        "std": [0.5, 0.5, 0.5],
        "input_width": args.size,
        "input_height": args.size,
    }
    dataset = build_dataset(opt)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False,
                        drop_last=False)
    total_batch = math.ceil(args.num_sample / args.batch_size)

    extract = load_patched_inception_v3(args.inception_weights, device=dev)
    features = extract_inception_features(
        dataset_batches(loader, total_batch, opt["mean"], opt["std"], dev),
        extract)[:args.num_sample]
    print(f"Extracted {features.shape[0]} features.")
    mean = np.mean(features, 0)
    cov = np.cov(features, rowvar=False)
    save_path = args.save_path or f"inception_{opt['name']}_{args.size}.npz"
    np.savez(save_path, name=opt["name"], size=args.size, mean=mean, cov=cov)
    print(f"saved stats to {save_path}")
    return save_path


if __name__ == "__main__":
    main()
