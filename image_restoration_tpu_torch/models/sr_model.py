"""SRModel — the L1/perceptual SR trainer, and the generator half of the
other trainers.

Port of `image_restoration_tpu/models/sr_model.py` (on one device, or over
a `torch.distributed` world: models/base_model.py):

  * the G build (and `pretrain_network_g`), its EMA copy, and the model's
    `torch.Generator` on its device (seeded from `manual_seed`) for the
    degradation;
  * the training step: the degradation on the device (when the dataset has
    one), the pixel and perceptual losses plus the `_extra_loss` hook
    (DistillModel's teacher term), Adam or the optimizer the config names
    (with its `grad_clip`), the static `grad_mask`, then the EMA at
    `ema_decay`; the losses stay on the device (`self.losses`);
  * quantization-aware training (`train.quant_opt`): the G forward becomes
    the fake-quant twin of the int8 serving graph (`ops/qat.py`), the
    activation scales `qscale` (num_conv + 3 of them) are moving averages
    of this step's maxima, `export_quantized` gives the serving weights,
    and `test` runs the twin at the learned scales;
  * `test` (the EMA net under `inference_mode`) and `validation`
    (degrading on the device with a generator seeded 0 for every batch,
    PSNR/SSIM through `calculate_metric`);
  * checkpoints: `ckpt_{iter}.pth` (the training state, `qscale` included)
    and `net_g_{iter}.pth` in the reference's {"params", "params_ema"}
    layout.
"""

from __future__ import annotations

import copy
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from ..losses import build_loss
from ..metrics import calculate_metric
from ..ops.qat import export_int8, qat_srvgg_forward, update_qscale
from ..utils.dist_util import in_world, rank_rows
from ..utils.img_util import imwrite, tensor2img
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


def _cpu(sd):
    return {k: v.detach().cpu() for k, v in sd.items()}


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device)
        train_opt = opt.get("train", {}) or {}
        self.net_g = self.build_net("network_g")
        pre = opt["path"].get("pretrain_network_g")
        if pre and pre.endswith((".pth", ".pt")):
            self.load_pretrain_torch(self.net_g, pre,
                                     opt["path"].get("param_key_g", "params"))
        self.net_g_ema = copy.deepcopy(self.net_g).eval().requires_grad_(False)
        self.ema_decay = train_opt.get("ema_decay", 0.999)
        self.iter = 0
        self.degrade_fn = None
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        # static train mask: parameter name → False for a frozen one (its
        # gradient is zero; the optimizer still steps it, as optax does)
        self.grad_mask: Optional[Dict[str, bool]] = None
        self.quant_opt = None
        self.qscale: Optional[torch.Tensor] = None
        if self.is_train:
            self._init_qat(train_opt)
            self.init_training_settings(train_opt)

    def init_training_settings(self, train_opt: dict) -> None:
        """The G optimizer and the pixel and perceptual losses."""
        def loss(key):
            return build_loss(train_opt[key]) if train_opt.get(key) else None

        self.cri_pix = loss("pixel_opt")
        self.cri_perceptual = loss("perceptual_opt")
        if self.cri_perceptual is not None:
            self.cri_perceptual.to(self.device)
        self.optimizer_g = self.make_optimizer("optim_g", self.net_g,
                                               lr_mul=self.g_lr_mul(train_opt))

    def g_lr_mul(self, train_opt: dict):
        """None, or the multiplier of each G parameter's update by name (the
        video trainers' `dcn_lr_mul` and `flow_lr_mul`)."""
        return None

    def _init_qat(self, train_opt: dict) -> None:
        """`train.quant_opt` (present, even empty, enables it): checks the
        trainer and the arch, and zeroes the scales."""
        raw = train_opt.get("quant_opt", None)
        if raw is None:
            return
        if type(self).optimize_parameters is not SRModel.optimize_parameters:
            raise ValueError(
                f"quant_opt is not supported by {type(self).__name__} "
                "(its train step does not thread the QAT scale state)")
        net_opt = self.opt["network_g"]
        if net_opt["type"] != "SRVGGNetCompact" or \
                net_opt.get("act_type", "prelu") != "prelu":
            raise ValueError(
                "quant_opt requires network_g: SRVGGNetCompact with "
                "act_type prelu (the int8 serving arch); got "
                f"type={net_opt['type']} "
                f"act_type={net_opt.get('act_type', 'prelu')}")
        self.quant_opt = {"ema_decay": 0.99, **(raw or {})}
        bits = int(self.quant_opt.get("weight_bits", 8))
        if not 2 <= bits <= 8:
            raise ValueError(f"quant_opt.weight_bits={bits} — the "
                             "fake-quant twin supports 2..8")
        self._qat_qmax = 2 ** (bits - 1) - 1
        self.qscale = torch.zeros(self.net_g.num_conv + 3,
                                  dtype=torch.float32, device=self.device)

    def set_degradation_pipeline(self, degrade_fn):
        self.degrade_fn = degrade_fn

    def to_device(self, arr) -> torch.Tensor:
        """A numpy array or a tensor (any device) on the model's device. A
        numpy batch goes to the card from pinned memory without waiting:
        a copy from pageable memory waits for the stream to drain."""
        if torch.is_tensor(arr):
            return arr.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------- train

    def g_forward(self, lq: torch.Tensor):
        """(output, this batch's activation maxima or None): the QAT twin at
        the tracked scales under quant_opt, else the plain net."""
        if self.quant_opt:
            return qat_srvgg_forward(self.net_g, lq, self.qscale,
                                     self._qat_qmax)
        out = self.net_g(lq)
        return (out[0] if isinstance(out, tuple) else out), None

    def _extra_loss(self, out: torch.Tensor, lq: torch.Tensor):
        """Loss terms of a subclass beside the pixel and perceptual ones
        ({name: loss}); DistillModel's teacher term."""
        return {}

    def g_losses(self, lq: torch.Tensor, gt: torch.Tensor):
        """(total, {name: loss}, output, batch maxima or None) of the step,
        summed in JAX's order: the extra terms, pixel, perceptual, style."""
        out, batch_max = self.g_forward(lq)
        losses = dict(self._extra_loss(out, lq))
        if self.cri_pix is not None:
            losses["l_pix"] = self.cri_pix(out, gt)
        if self.cri_perceptual is not None:
            l_p, l_s = self.cri_perceptual(out, gt)
            if l_p is not None:
                losses["l_percep"] = l_p
            if l_s is not None:
                losses["l_style"] = l_s
        total = 0.0
        for v in losses.values():
            total = total + v
        return total, losses, out, batch_max

    def degrade(self, batch, generator: Optional[torch.Generator] = None):
        """(lq, gt) of a batch on the device: its "gt" through the
        degradation pipeline when there is one, else its "lq" and "gt"."""
        gt = self.to_device(batch["gt"])
        if self.degrade_fn is None:
            return self.to_device(batch["lq"]), gt
        gen = generator or self.generator
        with torch.no_grad():
            if not in_world():
                return self.degrade_fn(gen, gt)
            return self._degrade_rank_rows(gen, gt)

    def _degrade_rank_rows(self, gen: torch.Generator, gt: torch.Tensor):
        """This rank's rows of the global batch's degradation: every
        parameter is drawn for the whole global batch from the shared
        generator (so all ranks stay in step) and cut to this rank's rows,
        so the rows equal the one-process step's. Draws that depend on the
        image (Real-ESRGAN's Poisson counts, `draws_in_apply`) come from a
        stream seeded by one shared draw plus the rank instead."""
        n, h, w, c = gt.shape
        n_global = n * self.world
        p = rank_rows(self.degrade_fn.sample(gen, n_global, h, w, c),
                      n_global, self.rank, self.world)
        if not getattr(self.degrade_fn, "draws_in_apply", False):
            return self.degrade_fn.apply(gt, p)
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=gen.device))
        local = torch.Generator(self.device).manual_seed(seed + self.rank)
        return self.degrade_fn.apply(gt, p, local)

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        """One G step on `batch` ("gt", or "lq" and "gt"; numpy or
        tensors). Returns the losses, detached on the device
        (`self.losses`): the step does not wait for the device."""
        lq, gt = self.degrade(batch, generator)
        self.optimizer_g.zero_grad()
        total, losses, _, batch_max = self.g_losses(lq, gt)
        total.backward()
        if self.grad_mask is not None:
            for name, p in self.net_g.named_parameters():
                if not self.grad_mask.get(name, True):
                    p.grad = None  # the optimizer steps it with zeros
        self.optimizer_g.step()
        self.ema_update(self.net_g_ema, self.net_g, self.ema_decay)
        if self.quant_opt:
            if in_world():  # the global batch's maxima
                torch.distributed.all_reduce(
                    batch_max, op=torch.distributed.ReduceOp.MAX)
            self.qscale = update_qscale(self.qscale, batch_max,
                                        self.quant_opt["ema_decay"])
        self.iter += 1
        self.losses = {k: v.detach() for k, v in losses.items()}
        return self.losses

    def export_quantized(self, pack: int = 2, use_ema: bool = True):
        """The QAT net at its learned scales → the int8 serving weights
        (`quantized_srvgg_forward`)."""
        if not self.quant_opt:
            raise RuntimeError(
                "export_quantized requires training with train.quant_opt "
                "(there are no learned activation scales to export); for "
                "a float model use the PTQ path "
                "(ops/quantized_inference.calibrate_srvgg_act_scales)")
        net = self.net_g_ema if use_ema else self.net_g
        return export_int8(net, self.qscale, pack=pack)

    # -------------------------------------------------------------- test

    def _test_out(self, lq: torch.Tensor) -> torch.Tensor:
        if self.quant_opt:  # what will be served: the twin, learned scales
            return qat_srvgg_forward(self.net_g_ema, lq, self.qscale)[0]
        out = self.net_g_ema(lq)
        return out[0] if isinstance(out, tuple) else out

    @torch.inference_mode()
    def test(self, lq) -> torch.Tensor:
        """The EMA net's output for an NHWC batch (array or tensor)."""
        return self._test_out(self.to_device(lq))

    def validation(self, dataloader, current_iter, tb_logger=None,
                   save_img: bool = False):
        """Mean of each `val.metrics` entry over the loader. A GT-only
        batch is degraded on the device with a generator seeded 0, and the
        restored image is scored against the (normalized) GT that the
        degradation returns; an LQ-only batch is restored and not
        scored."""
        metrics_opt = (self.opt.get("val", {}) or {}).get("metrics", {})
        results = {name: [] for name in metrics_opt}
        min_max = self.opt.get("val", {}).get("min_max", (0, 1))
        for batch in dataloader:
            if "lq" in batch:
                lq = self.to_device(batch["lq"])
                gt = batch.get("gt")
            else:
                gen = torch.Generator(self.device).manual_seed(0)
                with torch.inference_mode():
                    lq, gt = self.degrade_fn(gen, self.to_device(batch["gt"]))
            sr_img = tensor2img(self.test(lq), min_max=min_max)
            if gt is not None:
                gt_img = tensor2img(gt, min_max=min_max)
                for name, m_opt in metrics_opt.items():
                    results[name].append(calculate_metric(
                        {"img": sr_img, "img2": gt_img}, m_opt))
            if save_img:
                path = batch.get("gt_path", batch.get("lq_path", ["img"]))[0]
                name = osp.splitext(osp.basename(path))[0]
                dst = osp.join(self.opt["path"]["visualization"],
                               f"{name}_{current_iter}.png")
                imwrite(sr_img, dst)
        avg = {k: float(np.mean(v)) for k, v in results.items() if v}
        for name, val in avg.items():
            self.logger.info(f"Validation {name}: {val:.4f}")
            if tb_logger is not None:
                tb_logger.add_scalar(f"metrics/{name}", val, current_iter)
        return avg

    # -------------------------------------------------------- checkpoints

    def training_state(self) -> dict:
        state = {"params_g": self.net_g.state_dict(),
                 "ema_g": self.net_g_ema.state_dict(),
                 "opt_g": self.optimizer_g.state_dict(),
                 "iter": self.iter}
        if self.quant_opt:
            state["qscale"] = self.qscale
        return state

    def load_training_state(self, state: dict) -> None:
        self.net_g.load_state_dict(state["params_g"])
        self.net_g_ema.load_state_dict(state["ema_g"])
        self.optimizer_g.load_state_dict(state["opt_g"])
        if self.quant_opt:
            self.qscale = state["qscale"].to(self.device)
        self.iter = int(state["iter"])

    def save(self, current_iter: int):
        """The training state, and `net_g_{iter}.pth` in the reference's
        {"params", "params_ema"} layout."""
        path = super().save(current_iter)
        net_path = osp.join(osp.dirname(path), f"net_g_{current_iter}.pth")
        torch.save({"params": _cpu(self.net_g.state_dict()),
                    "params_ema": _cpu(self.net_g_ema.state_dict())},
                   net_path)
        return path
