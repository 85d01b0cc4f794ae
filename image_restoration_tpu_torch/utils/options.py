"""YAML config system.

Port of `image_restoration_tpu/utils/options.py:37-151`: the same schema and
the same CLI (`-opt`, `--auto_resume`, `--debug`, `--force_yml`). `yaml` is
imported where a file or a `--force_yml` value is read.
"""

from __future__ import annotations

import argparse
import os
import random
from collections import OrderedDict
from os import path as osp


def ordered_yaml():
    """Ordered yaml loader/dumper pair."""
    import yaml
    try:
        from yaml import CDumper as Dumper
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    _mapping_tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(_mapping_tag, dict_constructor)
    return Loader, Dumper


def dict2str(opt, indent_level=1):
    """Pretty-print a nested config."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + f"{k}: {v}\n"
    return msg


def parse(opt_path: str, root_path: str | None = None,
          is_train: bool = True, name: str | None = None) -> dict:
    """Load a YAML config and expand it; `name` replaces its `name` before
    the experiment paths are made from it."""
    import yaml
    with open(opt_path, "r") as f:
        opt = dict(yaml.load(f, Loader=ordered_yaml()[0]))
    if name is not None:
        opt["name"] = name
    opt["is_train"] = is_train

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        if "use_flip" in dataset and "use_hflip" not in dataset:
            dataset["use_hflip"] = dataset["use_flip"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    root_path = root_path or os.getcwd()
    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val and ("resume_state" in key or "pretrain_network" in key
                    or "param_key" in key or "strict_load" in key):
            continue
        if isinstance(val, str):
            opt["path"][key] = osp.expanduser(val)
    opt["path"]["root"] = root_path
    if is_train:
        experiments_root = osp.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_states"] = osp.join(experiments_root,
                                                  "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = osp.join(experiments_root,
                                                "visualization")
        if "debug" in opt["name"]:
            if "val" in opt:
                opt["val"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root,
                                                "visualization")
    return opt


def parse_options(root_path: str | None = None, is_train: bool = True,
                  argv=None):
    """CLI entry. Returns (opt, args)."""
    import yaml
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="e.g. train:total_iter=100")
    args = parser.parse_args(argv)

    opt = parse(args.opt, root_path=root_path, is_train=is_train)
    if args.debug and not opt["name"].startswith("debug"):
        # the experiment paths and the short frequencies of the debug name
        opt = parse(args.opt, root_path=root_path, is_train=is_train,
                    name="debug_" + opt["name"])
    opt["auto_resume"] = args.auto_resume

    for entry in args.force_yml or ():
        keys, value = entry.split("=", 1)
        node = opt
        *parents, leaf = keys.strip().split(":")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = yaml.safe_load(value.strip())

    if opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)
    return opt, args
