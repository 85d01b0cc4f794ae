"""SRModel — the generator half of the trainers.

Port of `image_restoration_tpu/models/sr_model.py` as far as the GFPGAN
trainer uses it: the G build (and `pretrain_network_g`), its EMA copy,
`set_degradation_pipeline`, `test` (the EMA net, fixed noise, under
`inference_mode`) and `validation` (degrading on the device with a
generator seeded 0 for every batch, PSNR/SSIM through `calculate_metric`).
Not ported yet: the SR L1 step (ROADMAP item 14) and quantization-aware
training (item 16).
"""

from __future__ import annotations

import copy
import os.path as osp

import numpy as np
import torch

from ..metrics import calculate_metric
from ..utils.img_util import imwrite, tensor2img
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device)
        train_opt = opt.get("train", {}) or {}
        if train_opt.get("quant_opt", None) is not None:
            raise NotImplementedError(
                "quantization-aware training (train.quant_opt) is not "
                "ported yet (ROADMAP item 16)")
        self.net_g = self.build_net("network_g")
        pre = opt["path"].get("pretrain_network_g")
        if pre and pre.endswith((".pth", ".pt")):
            self.load_pretrain_torch(self.net_g, pre,
                                     opt["path"].get("param_key_g", "params"))
        self.net_g_ema = copy.deepcopy(self.net_g).eval().requires_grad_(False)
        self.ema_decay = train_opt.get("ema_decay", 0.999)
        self.iter = 0
        self.degrade_fn = None

    def set_degradation_pipeline(self, degrade_fn):
        self.degrade_fn = degrade_fn

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        raise NotImplementedError(
            "the SR L1 training step is not ported yet (ROADMAP item 14)")

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

    # -------------------------------------------------------------- test

    def _test_out(self, lq: torch.Tensor) -> torch.Tensor:
        out = self.net_g_ema(lq)
        return out[0] if isinstance(out, tuple) else out

    @torch.inference_mode()
    def test(self, lq) -> torch.Tensor:
        """The EMA net's output for an NHWC batch (array or tensor)."""
        return self._test_out(self.to_device(lq))

    def validation(self, dataloader, current_iter: int, tb_logger=None,
                   save_img: bool = False):
        """Mean of each `val.metrics` entry over the loader. A GT-only
        batch is degraded on the device with a generator seeded 0, and the
        restored image is scored against the normalized GT that the
        degradation returns."""
        metrics_opt = (self.opt.get("val", {}) or {}).get("metrics", {})
        results = {name: [] for name in metrics_opt}
        min_max = self.opt.get("val", {}).get("min_max", (0, 1))
        for batch in dataloader:
            gt = self.to_device(batch["gt"])
            if "lq" in batch:
                lq = self.to_device(batch["lq"])
            else:
                gen = torch.Generator(self.device).manual_seed(0)
                with torch.inference_mode():
                    lq, gt = self.degrade_fn(gen, gt)
            sr_img = tensor2img(self.test(lq), min_max=min_max)
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
