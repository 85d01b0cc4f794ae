"""Training pipeline.

Port of `image_restoration_tpu/train.py`:

    python -m image_restoration_tpu_torch.train \\
        -opt configs/train_gfpgan_plate_256.yml [--auto_resume] [--debug] \\
        [--force_yml train:total_iter=100 ...]

With `num_devices: N` (N > 1) it trains the global-batch step over N
devices, one process each:

    torchrun --nproc_per_node N -m image_restoration_tpu_torch.train \\
        -opt configs/train_gfpgan_plate_256.yml --force_yml num_devices=N

Every rank reads its 1/N of each `batch_size_per_gpu` batch (the global
batch, as in JAX) and the gradients are averaged over the world
(`models/base_model.py`); rank 0 alone writes logs, checkpoints and
validates.

The device is cuda (it raises without a GPU); `train_pipeline(...,
device="cpu")` runs the plain PyTorch path on the CPU. GT batches are read
on the host; the degradation runs on the device inside each step, from the
model's generator. Checkpoints are `ckpt_{iter}.pth` (the training state,
which `--auto_resume` finds) and `net_g_{iter}.pth` (reference layout).
`debug_nans: true` turns on autograd's anomaly mode for the process
(utils/debug.py says how it differs from JAX's NaN checks).
"""

from __future__ import annotations

import logging
import os
import time
from os import path as osp

from .data import build_dataloader, build_dataset
from .models import build_model
from .utils.debug import enable_nan_checks
from .utils.dist_util import get_dist_info, init_dist
from .utils.logger import (AvgTimer, MessageLogger, get_env_info,
                           get_root_logger, init_tb_logger)
from .utils.misc import check_resume, make_exp_dirs, set_random_seed
from .utils.options import dict2str, parse_options


def load_resume_state(opt):
    """The newest `ckpt_{iter}.pth` with --auto_resume, else
    path.resume_state."""
    if opt.get("auto_resume"):
        state_dir = opt["path"]["models"]
        if osp.isdir(state_dir):
            iters = [int(f[len("ckpt_"):-len(".pth")])
                     for f in os.listdir(state_dir)
                     if f.startswith("ckpt_") and f.endswith(".pth")]
            if iters:
                path = osp.join(state_dir, f"ckpt_{max(iters)}.pth")
                opt["path"]["resume_state"] = path
                return path
        return None
    return opt["path"].get("resume_state") or None


def create_train_val_dataloader(opt, logger):
    train_loader, val_loader, train_dataset = None, None, None
    rank, world = get_dist_info()
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_dataset = build_dataset(dataset_opt)
            train_loader = build_dataloader(train_dataset, dataset_opt,
                                            seed=opt["manual_seed"],
                                            rank=rank, world=world)
            logger.info(f"Training set [{dataset_opt['name']}]: "
                        f"{len(train_dataset)} images, "
                        f"{len(train_loader)} iters/epoch")
        elif phase.split("_")[0] == "val":
            val_dataset = build_dataset(dataset_opt)
            val_loader = build_dataloader(val_dataset, dataset_opt)
            logger.info(f"Validation set [{dataset_opt['name']}]: "
                        f"{len(val_dataset)} images")
    return train_loader, val_loader, train_dataset


def train_pipeline(root_path: str | None = None, argv=None, device=None):
    """Parse the CLI (`argv`), build data and model, train, validate and
    save; returns the model. `device` None means cuda (in a world,
    cuda:LOCAL_RANK; "cpu" joins it over gloo)."""
    opt, _ = parse_options(root_path, is_train=True, argv=argv)
    set_random_seed(opt["manual_seed"])
    if (opt.get("num_devices") or 1) > 1 and get_dist_info()[1] == 1:
        init_dist("gloo" if str(device) == "cpu" else "nccl")
    rank = get_dist_info()[0]

    if opt.get("debug_nans"):  # anomaly mode (utils/debug.py)
        enable_nan_checks(True)

    resume_state_path = load_resume_state(opt)
    if rank == 0:
        if resume_state_path is None:
            make_exp_dirs(opt)
        os.makedirs(opt["path"]["log"], exist_ok=True)
        log_file = osp.join(opt["path"]["log"],
                            f"train_{opt['name']}_{int(time.time())}.log")
        logger = get_root_logger(log_file=log_file)
    else:  # the other ranks log warnings only, and write nothing
        logger = get_root_logger()
        logger.setLevel(logging.WARNING)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = None
    if opt["logger"].get("use_tb_logger") and rank == 0:
        tb_logger = init_tb_logger(osp.join(opt["path"]["experiments_root"],
                                            "tb_logger"))

    train_loader, val_loader, train_dataset = \
        create_train_val_dataloader(opt, logger)

    model = build_model(opt, device=device)
    degrade_fn = train_dataset.device_pipeline()
    if degrade_fn is not None:
        model.set_degradation_pipeline(degrade_fn)

    start_iter = 0
    if resume_state_path:
        check_resume(opt, 0)
        model.resume(resume_state_path)
        start_iter = model.iter
        logger.info(f"Resuming training from iter {start_iter}")

    msg_logger = MessageLogger(opt, start_iter + 1, tb_logger)
    total_iters = int(opt["train"]["total_iter"])
    val_opt = opt.get("val", {}) or {}
    val_freq = int(val_opt.get("val_freq", 0) or 0)
    save_freq = int(opt["logger"].get("save_checkpoint_freq", 0) or 0)
    print_freq = int(opt["logger"].get("print_freq", 100))

    current_iter = start_iter
    epoch = 0
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    logger.info(f"Start training from iter {current_iter}")
    while current_iter < total_iters:
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            data_timer.record()
            if current_iter >= total_iters:
                break
            current_iter += 1
            model.optimize_parameters(current_iter, batch)
            iter_timer.record()
            if current_iter % print_freq == 0:
                logs = {"epoch": epoch, "iter": current_iter,
                        "lrs": model.current_learning_rates(current_iter),
                        "time": iter_timer.get_avg_time(),
                        "data_time": data_timer.get_avg_time()}
                logs.update(model.log_dict)  # every rank: a collective
                if rank == 0:
                    msg_logger(logs)
            if save_freq and current_iter % save_freq == 0 and rank == 0:
                model.save(current_iter)
            if val_freq and val_loader is not None and rank == 0 and \
                    current_iter % val_freq == 0:
                model.validation(val_loader, current_iter, tb_logger,
                                 val_opt.get("save_img", False))
            data_timer.start()
            iter_timer.start()
        epoch += 1

    logger.info("End of training.")
    if rank != 0:
        return model
    model.save(current_iter)
    if val_loader is not None:
        model.validation(val_loader, current_iter, tb_logger,
                         val_opt.get("save_img", False))
    if tb_logger is not None:
        tb_logger.close()
    return model


if __name__ == "__main__":
    train_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir)))
