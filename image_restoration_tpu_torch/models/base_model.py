"""BaseModel — the trainers' shared machinery.

Port of `image_restoration_tpu/models/base_model.py`:

  * `TrainOptimizer`: Adam, AdamW or SGD with the lr of
    `build_schedule(...)(count)` at each update's count (optax's
    convention), optax's global-norm `grad_clip`, and a `frozen_prefix`
    whose parameters get neither updates nor moments (what `optax.masked`
    does for `fix_decoder`);
  * `ema_update`: e·decay + p·(1 − decay), under no_grad;
  * checkpoints: `ckpt_{iter}.pth` holds the training state (`torch.save`)
    that `resume` reads, where JAX writes an orbax directory; the trainer
    adds the reference's `{"params", "params_ema"}` files;
  * `load_pretrain_torch`: a reference `.pth` through `load_state_dict`;
  * `num_devices: N` above 1: the step of JAX's global batch over N
    devices, as N processes of a `torch.distributed` world (`torchrun
    --nproc_per_node N -m image_restoration_tpu_torch.train`). Each rank
    takes its 1/N of the global batch (`batch_size_per_gpu`), the
    optimizers average the gradients over the world before each update,
    and the logged losses are the world's means (`utils/dist_util.py`).
    Without a matching world it raises.
"""

from __future__ import annotations

import os
from os import path as osp
from typing import Callable, Dict, Optional

import torch

from ..archs import build_network
from ..convert.pth import load_pth
from ..utils.device import resolve_device
from ..utils.dist_util import (average_gradients, get_dist_info, in_world,
                               local_device, reduce_loss_dict)
from ..utils.logger import get_root_logger
from .lr_scheduler import build_schedule


class TrainOptimizer:
    """A torch optimizer over the named parameters of `net` outside
    `frozen_prefix`, stepping at lr = schedule(updates so far), times
    `lr_mul(name)` for each parameter: the update scaled, as an
    `optax.masked(optax.scale(m))` after the optimizer scales it
    (EDVR's `dcn_lr_mul`, BasicVSR's `flow_lr_mul`)."""

    def __init__(self, net: torch.nn.Module, opt_cfg: dict, train_opt: dict,
                 frozen_prefix: Optional[str] = None, lr_scale: float = 1.0,
                 betas=(0.9, 0.999),
                 lr_mul: Optional[Callable[[str], float]] = None):
        opt_cfg = dict(opt_cfg)
        opt_type = opt_cfg.pop("type", "Adam").lower()
        lr = float(opt_cfg.pop("lr", 1e-4)) * lr_scale
        betas = tuple(opt_cfg.pop("betas", betas))
        self.grad_clip = opt_cfg.pop("grad_clip", None)
        self.schedule = build_schedule(train_opt, lr)
        named = [(name, p) for name, p in net.named_parameters()
                 if frozen_prefix is None
                 or name.split(".")[0] != frozen_prefix]
        self.params = [p for _, p in named]
        groups = {}
        for name, p in named:
            groups.setdefault(1.0 if lr_mul is None else float(lr_mul(name)),
                              []).append(p)
        params = [{"params": ps, "lr_mul": m} for m, ps in groups.items()]
        if opt_type == "adam":
            self.opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
        elif opt_type == "adamw":
            self.opt = torch.optim.AdamW(
                params, lr=lr, betas=betas, eps=1e-8,
                weight_decay=opt_cfg.get("weight_decay", 0.0))
        elif opt_type == "sgd":
            self.opt = torch.optim.SGD(params, lr=lr,
                                       momentum=opt_cfg.get("momentum", 0.9))
        else:
            raise ValueError(f"unsupported optimizer {opt_type}")
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _clip(self, max_norm: float):
        """optax.clip_by_global_norm: g·max/‖g‖ when ‖g‖ ≥ max."""
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in self.params]))
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        torch._foreach_mul_([p.grad for p in self.params], factor)

    def step(self):
        """One update. A parameter without a gradient takes a zero one, so
        its moments decay as optax's do."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(self.params)  # the world's mean (no-op alone)
        if self.grad_clip:
            self._clip(float(self.grad_clip))
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr * group.get("lr_mul", 1.0)
        self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


class BaseModel:
    def __init__(self, opt: dict, device=None):
        self.opt = opt
        self.is_train = opt.get("is_train", True)
        self.logger = get_root_logger()
        self.rank, self.world = get_dist_info()
        n = opt.get("num_devices")
        if n is not None and n != self.world and (n > 1 or self.world > 1):
            raise RuntimeError(
                f"num_devices={n} needs a torch.distributed world of {n} "
                f"processes, one a device (this one is in a world of "
                f"{self.world}); start it with torchrun --nproc_per_node "
                f"{n} -m image_restoration_tpu_torch.train -opt ...")
        self.device = (local_device(device) if in_world()
                       else resolve_device(device))
        self.seed = opt.get("manual_seed", 0) or 0
        self.optimizers = []
        # the last step's losses, detached on the device: the step itself
        # never waits for them; `log_dict` copies them to the host
        self.losses: Dict[str, torch.Tensor] = {}

    def build_net(self, opt_key: str) -> torch.nn.Module:
        """The network of `opt[opt_key]`, drawn from the config's seed, on
        the model's device."""
        gen = torch.Generator().manual_seed(self.seed)
        return build_network(self.opt[opt_key], gen).to(self.device)

    def make_optimizer(self, train_opt_key: str, net: torch.nn.Module,
                       frozen_prefix: Optional[str] = None,
                       lr_scale: float = 1.0, betas=(0.9, 0.999),
                       lr_mul=None) -> TrainOptimizer:
        tx = TrainOptimizer(net, self.opt["train"][train_opt_key],
                            self.opt["train"], frozen_prefix, lr_scale, betas,
                            lr_mul)
        self.optimizers.append(tx)
        return tx

    def current_learning_rates(self, count: int):
        return [tx.schedule(count) for tx in self.optimizers]

    @staticmethod
    @torch.no_grad()
    def ema_update(ema_net: torch.nn.Module, net: torch.nn.Module,
                   decay: float) -> None:
        """ema ← ema·decay + p·(1 − decay), every parameter."""
        ema = list(ema_net.parameters())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, list(net.parameters()), alpha=1.0 - decay)

    # -------------------------------------------------------- checkpoints

    def _ckpt_dir(self):
        return self.opt["path"].get("models", "experiments/models")

    def training_state(self) -> dict:
        raise NotImplementedError

    def load_training_state(self, state: dict) -> None:
        raise NotImplementedError

    def save(self, current_iter: int):
        """Write the training state to `ckpt_{iter}.pth`."""
        path = osp.abspath(osp.join(self._ckpt_dir(),
                                    f"ckpt_{current_iter}.pth"))
        os.makedirs(osp.dirname(path), exist_ok=True)
        torch.save(self.training_state(), path)
        self.logger.info(f"Saved checkpoint {path}")
        return path

    def resume(self, path: str):
        state = torch.load(path, map_location=self.device,
                           weights_only=True)
        self.load_training_state(state)
        self.logger.info(f"Resumed from {path} at iter {self.iter}")

    def load_pretrain_torch(self, net: torch.nn.Module, pth_path: str,
                            param_key: str = "params"):
        input_is_latent = bool(getattr(net, "input_is_latent", False))
        net.load_state_dict(load_pth(pth_path, param_key, input_is_latent),
                            strict=True)
        self.logger.info(f"Loaded {pth_path} ({param_key})")

    # ----------------------------------------------------------- logging

    @property
    def log_dict(self) -> Dict[str, float]:
        """The last step's losses as floats (waits for the step)."""
        return self.reduce_loss_dict(self.losses)

    @staticmethod
    def reduce_loss_dict(loss_dict) -> Dict[str, float]:
        """Scalar tensors (on one device) to floats, with one copy to the
        host; in a world, the world's means (every rank must call it)."""
        return reduce_loss_dict(loss_dict)
