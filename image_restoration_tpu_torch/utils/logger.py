"""Logging.

Port of `image_restoration_tpu/utils/logger.py`: `AvgTimer`, the
`MessageLogger` line format ([name..][epoch, iter, lr] [eta, time,
data_time] losses) with TensorBoard scalars, `init_tb_logger` (None when
no SummaryWriter can be imported) and the root logger. One process, so
there is no rank gating.
"""

from __future__ import annotations

import datetime
import logging
import time

initialized_logger = {}


class AvgTimer:
    """Wall-clock timer with a running average over a window."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """Format training log lines and push scalars to TensorBoard."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.interval = opt["logger"]["print_freq"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.use_tb_logger = opt["logger"].get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars: dict):
        epoch = log_vars.pop("epoch")
        current_iter = log_vars.pop("iter")
        lrs = log_vars.pop("lrs")

        message = (f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        for v in lrs:
            message += f"{v:.3e},"
        message += ")] "

        if "time" in log_vars.keys():
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta_str}, "
            message += f"time (data): {iter_time:.3f} ({data_time:.3f})] "

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                label = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(label, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A TensorBoard SummaryWriter, or None when neither torch's nor
    tensorboardX's can be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir=log_dir)


def get_root_logger(logger_name: str = "image_restoration_tpu_torch",
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The package's logger: a stream handler, and a file handler for the
    first `log_file` given."""
    logger = logging.getLogger(logger_name)
    if logger_name in initialized_logger:
        if log_file is not None and not initialized_logger[logger_name]:
            _add_file_handler(logger, log_file, log_level)
            initialized_logger[logger_name] = True
        return logger
    format_str = "%(asctime)s %(levelname)s: %(message)s"
    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter(format_str))
    logger.addHandler(stream_handler)
    logger.propagate = False
    logger.setLevel(log_level)
    if log_file is not None:
        _add_file_handler(logger, log_file, log_level)
    initialized_logger[logger_name] = log_file is not None
    return logger


def _add_file_handler(logger, log_file, log_level):
    file_handler = logging.FileHandler(log_file, "w")
    file_handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s: %(message)s"))
    file_handler.setLevel(log_level)
    logger.addHandler(file_handler)


def get_env_info() -> str:
    import torch
    import image_restoration_tpu_torch
    dev = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
           else "no CUDA device")
    return ("\nFramework: image_restoration_tpu_torch "
            f"{image_restoration_tpu_torch.__version__}"
            f"\n\tPyTorch: {torch.__version__} (CUDA {torch.version.cuda})"
            f"\n\tdevice: {dev}")
