"""Video SR trainers.

Port of `image_restoration_tpu/models/video_models.py`:

  * `VideoBaseModel` (:27): SRModel over (N, T, H, W, 3) clips, with
    folder-grouped validation (`{folder}/{metric}` means; a whole-clip
    output is scored at its centre frame, as JAX scores it). JAX's
    `num_frame` fallback sizes the example its params are initialized
    from; a PyTorch net needs none, so it has no counterpart here;
  * `EDVRModel` (:98): below `train.tsa_iter` only the `fusion` (TSA)
    parameters train, and `dcn_lr_mul` scales the updates of every
    parameter whose name holds `dcn`;
  * `VideoRecurrentModel` (:144): below `train.fix_flow` the `spynet` and
    `edvr` parameters stay frozen, `flow_lr_mul` scales the SpyNet
    updates, and `test` takes `val.flip_seq` (the clip mirrored to 2T
    frames, the two passes averaged) and `val.center_frame_only`;
  * `VideoGANModel` (:218) and `VideoRecurrentGANModel` (:224): the SRGAN
    losses on the clips' frames.

A frozen parameter takes no gradient (`requires_grad` off for the phase,
so autograd does no backward work for it, as JAX's masked step graph
does) and a zero update: the optimizer steps it with a zero gradient and
zero moments, so it stays bit-unchanged, as under JAX's mask.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..metrics import calculate_metric
from ..utils.img_util import tensor2img
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    # the phase's trainable-parameter predicate, None while all train
    _phase = None

    def trainable(self, current_iter: int):
        """None (every parameter trains) or a predicate on names, for the
        step at `current_iter`."""
        return None

    def set_train_phase(self, current_iter: int) -> None:
        """Freeze or thaw net_g's parameters where the phase changes."""
        pred = self.trainable(current_iter)
        if pred is self._phase:
            return
        self._phase = pred
        for name, p in self.net_g.named_parameters():
            p.requires_grad_(pred is None or pred(name))

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        self.set_train_phase(current_iter)
        return super().optimize_parameters(current_iter, batch, generator)

    def validation(self, dataloader, current_iter, tb_logger=None,
                   save_img: bool = False):
        """Mean of each `val.metrics` entry per folder, as
        {'folder/metric': value}. `save_img` is not read, as in JAX."""
        metrics_opt = (self.opt.get("val", {}) or {}).get("metrics", {})
        per_folder = defaultdict(lambda: defaultdict(list))
        for batch in dataloader:
            # float32, as JAX's jnp.asarray makes DUF's float64 frames
            out = self.test(np.asarray(batch["lq"], np.float32))
            gt = np.asarray(batch["gt"])
            if out.dim() == 5:  # a whole clip: score its centre frame
                if gt.ndim == 5:
                    gt = gt[:, gt.shape[1] // 2]
                out = out[:, out.shape[1] // 2]
            sr_img, gt_img = tensor2img(out), tensor2img(gt)
            folder = batch.get("folder", ["all"])[0]
            for name, m_opt in metrics_opt.items():
                per_folder[folder][name].append(calculate_metric(
                    {"img": sr_img, "img2": gt_img}, m_opt))
        results = {}
        for folder, metrics in per_folder.items():
            for name, vals in metrics.items():
                key = f"{folder}/{name}"
                results[key] = float(np.mean(vals))
                self.logger.info(f"Validation {folder} {name}: "
                                 f"{results[key]:.4f}")
                if tb_logger is not None:
                    tb_logger.add_scalar(f"metrics/{key}", results[key],
                                         current_iter)
        return results


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):
    def __init__(self, opt: dict, device=None):
        self.train_tsa_iter = (opt.get("train", {}) or {}).get(
            "tsa_iter", 0) or 0
        super().__init__(opt, device)

    def g_lr_mul(self, train_opt: dict):
        mul = float(train_opt.get("dcn_lr_mul", 1) or 1)
        if mul == 1:
            return None
        return lambda name: mul if "dcn" in name else 1.0

    @staticmethod
    def _only_fusion(name: str) -> bool:
        return "fusion" in name

    def trainable(self, current_iter: int):
        if self.train_tsa_iter and current_iter < self.train_tsa_iter:
            if self._phase is None:
                self.logger.info(f"Only train TSA module for "
                                 f"{self.train_tsa_iter} iters.")
            return self._only_fusion
        if self._phase is not None:
            self.logger.warning("Train all the parameters.")
        return None


@MODEL_REGISTRY.register()
class VideoRecurrentModel(VideoBaseModel):
    def __init__(self, opt: dict, device=None):
        self.fix_flow_iter = (opt.get("train", {}) or {}).get(
            "fix_flow") or 0
        super().__init__(opt, device)

    def g_lr_mul(self, train_opt: dict):
        mul = float(train_opt.get("flow_lr_mul", 1.0))
        if mul == 1.0:
            return None
        return lambda name: mul if name.split(".")[0] == "spynet" else 1.0

    @staticmethod
    def _not_flow(name: str) -> bool:
        return "spynet" not in name and "edvr" not in name

    def trainable(self, current_iter: int):
        if self.fix_flow_iter and current_iter < self.fix_flow_iter:
            if self._phase is None:
                self.logger.info("Fix flow network and feature extractor "
                                 f"for {self.fix_flow_iter} iters.")
            return self._not_flow
        if self._phase is not None:
            self.logger.warning("Train all the parameters.")
        return None

    @torch.inference_mode()
    def test(self, lq) -> torch.Tensor:
        val_opt = self.opt.get("val", {}) or {}
        lq = self.to_device(lq)
        n = lq.shape[1]
        if val_opt.get("flip_seq", False):
            lq = torch.cat([lq, lq.flip(1)], dim=1)
        out = self._test_out(lq)
        if val_opt.get("flip_seq", False):
            out = 0.5 * (out[:, :n] + out[:, n:].flip(1))
        if val_opt.get("center_frame_only", False):
            out = out[:, n // 2]
        return out


@MODEL_REGISTRY.register()
class VideoGANModel(SRGANModel, VideoBaseModel):
    def optimize_parameters(self, current_iter: int, batch, generator=None):
        self.set_train_phase(current_iter)
        return SRGANModel.optimize_parameters(self, current_iter, batch,
                                              generator)


@MODEL_REGISTRY.register()
class VideoRecurrentGANModel(SRGANModel, VideoRecurrentModel):
    def optimize_parameters(self, current_iter: int, batch, generator=None):
        self.set_train_phase(current_iter)
        return SRGANModel.optimize_parameters(self, current_iter, batch,
                                              generator)
