"""Misc utilities.

Port of `image_restoration_tpu/utils/misc.py` (seeding, experiment
directories, `scandir`, `check_resume`, `sizeof_fmt`). Training checkpoints are `.pth`
files here, so `check_resume` points the pretrain paths at `net_*_{iter}.pth`.
"""

from __future__ import annotations

import os
import random
import time
from os import path as osp

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs: Python's, numpy's and torch's default generators.
    Device randomness comes from explicit `torch.Generator`s seeded from the
    config's seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; archive an existing dir with a timestamp."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """Create experiment directories."""
    path_opt = opt["path"].copy()
    if opt["is_train"]:
        mkdir_and_rename(path_opt.pop("experiments_root"))
    else:
        mkdir_and_rename(path_opt.pop("results_root"))
    for key, path in path_opt.items():
        if ("strict_load" in key or "pretrain_network" in key
                or "resume" in key or "param_key" in key or key == "root"):
            continue
        if isinstance(path, str) and path:
            os.makedirs(path, exist_ok=True)


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False):
    """Scan a directory for files (hidden ones skipped)."""
    if isinstance(suffix, str):
        suffix = (suffix,)

    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                if full_path:
                    return_path = entry.path
                else:
                    return_path = osp.relpath(entry.path, root)
                if suffix is None or return_path.endswith(tuple(suffix)):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix, recursive)

    return _scandir(dir_path, suffix, recursive)


def check_resume(opt: dict, resume_iter: int) -> None:
    """Rewire pretrain paths when resuming."""
    if opt["path"].get("resume_state"):
        networks = [key for key in opt.keys() if key.startswith("network_")]
        flag_pretrain = any(
            opt["path"].get(f"pretrain_{n}") is not None for n in networks)
        if flag_pretrain:
            print("pretrain_network paths will be ignored during resuming.")
        for network in networks:
            name = f"pretrain_{network}"
            basename = network.replace("network_", "")
            if opt["path"].get("ignore_resume_networks") is None or \
                    network not in opt["path"]["ignore_resume_networks"]:
                opt["path"][name] = osp.join(
                    opt["path"]["models"],
                    f"net_{basename}_{resume_iter}.pth")


def sizeof_fmt(size: float, suffix: str = "B") -> str:
    """A byte count in binary units, e.g. `1.5 KB` (JAX
    `utils/misc.py:89-94`)."""
    for unit in ("", "K", "M", "G", "T", "P", "E", "Z"):
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"
