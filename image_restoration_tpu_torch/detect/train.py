"""Detector training on one GPU, or data-parallel over several.

Port of `image_restoration_tpu/detect/train.py:27-248` (parity with
Plate_Detect/Retina-License-Plate/train.py:95-169): SGD with momentum 0.9
and weight decay 5e-4 added to the gradient before the momentum trace
(optax's `add_decayed_weights` then `sgd`, which is `torch.optim.SGD`'s
`weight_decay`), lr 1e-3 with a ×0.1 step at each decay step, loss =
loc_weight·L_loc + L_conf + L_landm. The BatchNorms run in train mode and
carry their running statistics from step to step.

The learning rate is read from the trainer's own `step` before each update
(JAX reads it from `state["step"]`, not from optax's count), so a resume
that sets `step` fast-forwards the decay, as the reference recomputes its
lr from the resumed epoch (train.py:121,154-166).

Checkpoints are the reference's `.pth` layout (a state_dict with the
reference's key names) where JAX writes orbax: `PlateDetector.load` and
`scripts/export_detector.py` read them strictly. Like JAX's, they hold the
weights and the BatchNorm statistics, not the momentum trace.

    python -m image_restoration_tpu_torch.detect.train \\
        --training_dataset data/train/label.txt --network resnet18

`data_parallel=N` (`--data_parallel N`, under `torchrun --nproc_per_node
N`) trains JAX's data-parallel step (detect/train.py:33-82): the global
batch is split over the world's N ranks, the SGD gradients are averaged
over it, train-mode BatchNorm and the loss normalizers count the global
batch (`utils/dist_util.py`); rank 0 writes the checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..archs import build_network
from ..utils.device import resolve_device
from ..utils.dist_util import (average_gradients, check_global_batch,
                               get_dist_info, in_world, init_dist,
                               local_device)
from ..utils.logger import get_root_logger
from .config import get_cfg
from .multibox_loss import multibox_loss
from .priors import prior_box


class DetectorTrainer:
    """RetinaFace training state: the net (train mode), SGD and the step.

    Parameters are drawn from a generator seeded with 0 (the trunk from
    `resnet_pretrain_path` when given). `device=None` means "cuda" and
    raises without a GPU; with `data_parallel=N` > 1 the process must be
    one of a `torch.distributed` world of N (its device cuda:LOCAL_RANK
    unless `device` is given), and `train_step` takes the global batch.
    """

    def __init__(self, backbone: str = "Resnet18", image_size: int = 224,
                 lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 5e-4,
                 resnet_pretrain_path: Optional[str] = None,
                 decay_steps=(), data_parallel: int = 0, device=None):
        self.rank, self.world = get_dist_info()
        self.data_parallel = int(data_parallel or 0)
        if max(self.data_parallel, 1) != self.world:
            raise RuntimeError(
                f"data_parallel={data_parallel} needs a torch.distributed "
                f"world of {max(self.data_parallel, 1)} processes (this one "
                f"is in a world of {self.world}); start it with torchrun "
                "--nproc_per_node N")
        self.device = (local_device(device) if in_world()
                       else resolve_device(device))
        self.cfg = get_cfg(backbone)
        self.image_size = image_size
        self.net = build_network(
            dict(type="RetinaFace", backbone=backbone,
                 out_channel=self.cfg["out_channel"], phase="train"),
            torch.Generator().manual_seed(0))
        if resnet_pretrain_path:
            from ..convert.resnet_import import load_torchvision_resnet
            load_torchvision_resnet(resnet_pretrain_path, self.net)
        self.net.to(self.device).train()
        self.priors = torch.from_numpy(prior_box(
            self.cfg, (image_size, image_size))).to(self.device)
        self.lr = lr
        # optax.piecewise_constant_schedule: ×0.1 from each boundary on
        # (a dict, so equal boundaries count once, as in JAX)
        self.boundaries = sorted({int(s) for s in decay_steps})
        self.optimizer = torch.optim.SGD(
            self.net.parameters(), lr=lr, momentum=momentum,
            weight_decay=weight_decay)
        self.step = 0
        self.last_losses: dict = {}
        self.logger = get_root_logger()

    def lr_at(self, step: int) -> float:
        lr = self.lr
        for b in self.boundaries:
            if step >= b:
                lr *= 0.1
        return lr

    def losses(self, images: torch.Tensor, targets: torch.Tensor):
        """(total, {name: loss}) of one forward in train mode: the
        BatchNorms normalize with this batch and move their statistics."""
        preds = self.net(images)
        l_loc, l_conf, l_landm = multibox_loss(
            preds, self.priors, targets, tuple(self.cfg["variance"]))
        total = self.cfg["loc_weight"] * l_loc + l_conf + l_landm
        return total, {"loss": total, "l_loc": l_loc, "l_conf": l_conf,
                       "l_landm": l_landm}

    def train_step(self, images, targets) -> dict:
        """One SGD step on (B, S, S, 3) mean-subtracted BGR images and
        (B, M, 15) targets (numpy or tensors): the global batch, of which
        each rank of a world takes its 1/world. Returns this rank's losses
        (also kept as `last_losses`; their world mean is the global
        batch's) as detached 0-dim tensors on the device: nothing waits on
        the card."""
        if in_world():
            n = check_global_batch(len(images), self.world)
            images = images[self.rank * n:(self.rank + 1) * n]
            targets = targets[self.rank * n:(self.rank + 1) * n]
        dtype = self.priors.dtype  # float32 unless the net was cast
        images = torch.as_tensor(images).to(self.device, dtype)
        targets = torch.as_tensor(targets).to(self.device, dtype)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.losses(images, targets)
        total.backward()
        average_gradients(self.net.parameters())
        self.optimizer.step()
        self.step += 1
        self.last_losses = {k: v.detach() for k, v in losses.items()}
        return self.last_losses

    def fit(self, dataset, epochs: int, batch_size: int = 24,
            log_every: int = 10):
        """`epochs` passes over `dataset` (a map-style dataset of
        {"image", "target"}), shuffled per epoch, the last partial batch
        dropped."""
        from ..data.loader import DataLoader
        loader = DataLoader(dataset, batch_size, shuffle=True,
                            drop_last=True)
        it = 0
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                t0 = time.time()
                losses = self.train_step(batch["image"], batch["target"])
                it += 1
                if it % log_every == 0:
                    msg = " ".join(f"{k}:{float(v):.4f}"
                                   for k, v in losses.items())
                    self.logger.info(f"epoch {epoch} iter {it} {msg} "
                                     f"({time.time() - t0:.2f}s/it)")
        return self

    def save(self, path: str):
        """Write the net's weights and BatchNorm statistics under the
        reference checkpoint's key names (`PlateDetector.load` reads the
        `.pth` strictly)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({k: v.detach().cpu()
                    for k, v in self.net.state_dict().items()}, path)

    def load(self, path: str):
        """Load a `.pth` written by `save` (or a reference checkpoint)
        strictly; the momentum trace starts afresh, as in JAX."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        own = self.net.state_dict()
        for k, v in own.items():
            if k.endswith("num_batches_tracked") and k not in sd:
                sd[k] = v
        self.net.load_state_dict(sd, strict=True)


# Backbone aliases: the reference CLI calls them 'mobile0.25'/'resnet50'
# (Plate_Detect/Retina-License-Plate/train.py:18) while the arch registry
# uses the cfg names.
_BACKBONE_ALIASES = {"mobile0.25": "mobilenet0.25",
                     "mobilenet0.25": "mobilenet0.25",
                     "resnet18": "Resnet18", "Resnet18": "Resnet18",
                     "resnet50": "Resnet50", "Resnet50": "Resnet50",
                     "mobilenetv3": "MobilenetV3",
                     "MobilenetV3": "MobilenetV3"}


def main(argv=None):
    """CLI parity with Plate_Detect/Retina-License-Plate/train.py:17-28:
    the SGD hyperparameters, the epoch and decay schedule and the default
    batch size come from the per-backbone cfg as the reference's do. The
    loader is one host thread, so `--num_workers` is accepted and not read.
    Returns the trainer."""
    import argparse

    p = argparse.ArgumentParser(
        description="RetinaFace plate-detector training")
    p.add_argument("--training_dataset",
                   default="./data/licenseplate/train/label.txt",
                   help="label.txt in the reference annotation format")
    p.add_argument("--network", default="resnet18",
                   help="mobile0.25 | resnet18 | resnet50 | mobilenetv3")
    p.add_argument("--num_workers", default=4, type=int,
                   help="accepted for CLI parity; the loader is one thread")
    p.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--resume_net", default=None,
                   help=".pth saved by this trainer (or a reference one)")
    p.add_argument("--resume_epoch", default=0, type=int)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--gamma", default=0.1, type=float,
                   help="accepted for parity; decay factor is 0.1 as in cfg")
    p.add_argument("--save_folder", default="./weights/")
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--batch_size", default=None, type=int,
                   help="default: the per-backbone cfg batch_size")
    p.add_argument("--epochs", default=None, type=int,
                   help="default: the per-backbone cfg epoch count")
    p.add_argument("--resnet_pretrain", default=None,
                   help="torchvision resnet18/50 .pth for the trunk")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--data_parallel", default=0, type=int,
                   help="N > 1: one of N processes started by torchrun")
    args = p.parse_args(argv)
    if args.data_parallel > 1:
        init_dist("gloo" if args.device == "cpu" else "nccl")

    backbone = _BACKBONE_ALIASES[args.network]
    cfg = get_cfg(backbone)
    batch_size = args.batch_size or cfg["batch_size"]
    epochs = args.epochs or cfg["epoch"]
    from .dataset import LicensePlateDetection
    dataset = LicensePlateDetection(args.training_dataset,
                                    image_size=args.image_size)
    steps_per_epoch = max(1, len(dataset) // batch_size)
    decay_steps = [cfg["decay1"] * steps_per_epoch,
                   cfg["decay2"] * steps_per_epoch]
    trainer = DetectorTrainer(
        backbone=backbone, image_size=args.image_size, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        resnet_pretrain_path=args.resnet_pretrain,
        decay_steps=decay_steps, data_parallel=args.data_parallel,
        device=args.device)
    if args.resume_net:
        trainer.load(args.resume_net)
        trainer.step = args.resume_epoch * steps_per_epoch
    trainer.fit(dataset, epochs=epochs - args.resume_epoch,
                batch_size=batch_size)
    if trainer.rank == 0:
        out = os.path.join(args.save_folder, f"{backbone}_final.pth")
        trainer.save(out)
        trainer.logger.info(f"saved final checkpoint to {out}")
    return trainer


if __name__ == "__main__":
    main()
