"""DistillModel — frozen-teacher knowledge distillation.

Port of `image_restoration_tpu/models/distill_model.py` (whole): a frozen
teacher (`network_t`, e.g. RRDBNet-23) supervises a student (`network_g`,
e.g. the SRVGG that `/SRx4/` serves) through SRModel's step, by its
`_extra_loss` hook:

  * ``distill_opt`` (required): the student's output against the teacher's
    on the same LQ, detached and cast to the student's dtype;
  * ``pixel_opt`` and ``perceptual_opt`` against the GT, as SRModel's.

The teacher is built from `pretrain_network_t` (a reference `.pth`, or a
`net_g_{iter}.pth` of one of this package's runs); it is left out of the
optimizer, the EMA and the checkpoint, and takes no gradient, so it stays
bit-frozen. `network_t` may set `dtype: bf16` while the student trains in
float32. With no teacher weights the first step refuses to train, unless
`train.allow_random_teacher` is set (for smoke tests), or weights come
through `set_teacher_params`. `train.quant_opt` composes with it: the
student then trains through the fake-quant twin.
"""

from __future__ import annotations

import torch

from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class DistillModel(SRModel):
    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device)
        self.net_t = self.build_net("network_t").eval().requires_grad_(False)
        pre_t = opt["path"].get("pretrain_network_t")
        if pre_t:
            if not pre_t.endswith((".pth", ".pt")):
                raise ValueError(
                    f"pretrain_network_t={pre_t!r} is not a torch .pth/.pt "
                    "file (a run of this package writes net_g_{iter}.pth) "
                    "— refusing to distill from a random-init teacher")
            self.load_pretrain_torch(self.net_t, pre_t,
                                     opt["path"].get("param_key_t", "params"))
        # a falsy path means no teacher was configured: the step refuses
        # until one is installed, unless allow_random_teacher opts out
        self._teacher_loaded = bool(pre_t)
        train_opt = opt.get("train", {}) or {}
        if not self._teacher_loaded and train_opt.get("allow_random_teacher"):
            self.logger.warning(
                "DistillModel: allow_random_teacher is set — training "
                "against a RANDOM-INIT teacher (smoke-test mode)")
            self._teacher_loaded = True
        if self.is_train:
            if "distill_opt" not in train_opt:
                raise ValueError(
                    "DistillModel requires train.distill_opt (the "
                    "teacher-supervision loss)")
            self.cri_distill = build_loss(train_opt["distill_opt"])

    def set_teacher_params(self, state_dict) -> None:
        """Install teacher weights (a state_dict of `network_t`)."""
        self.net_t.load_state_dict(state_dict)
        self._teacher_loaded = True

    def _extra_loss(self, out: torch.Tensor, lq: torch.Tensor):
        if not self._teacher_loaded:
            raise ValueError(
                "DistillModel has no teacher weights: set "
                "path.pretrain_network_t (a torch .pth/.pt) or call "
                "set_teacher_params() before training — refusing to distill "
                "from a random-init teacher")
        with torch.no_grad():
            t_out = self.net_t(lq)
        if isinstance(t_out, tuple):
            t_out = t_out[0]
        return {"l_distill": self.cri_distill(out, t_out.to(out.dtype))}
