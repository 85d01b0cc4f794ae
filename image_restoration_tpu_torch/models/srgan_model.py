"""SRGANModel — SR with an adversarial loss.

Port of `image_restoration_tpu/models/srgan_model.py` (whole) on one
device: the G step (pixel, perceptual and GAN losses through D, D's
parameters taking no gradient), the `net_d_iters` / `net_d_init_iters`
gate (a skipped G iteration runs a G forward without an update, then the
EMA and the D step all the same), the D step on the detached output, and
for a BatchNorm D the refresh of its running statistics once per step.

D runs in train mode throughout: a BatchNorm normalizes with the batch's
statistics and does not move its running ones (JAX runs D in batch-stat
mode in every training call). After the D update, `_refresh_d_stats` moves
them from the GT and then from the detached output, as JAX's
`_refresh_d_stats` does, for a later eval or export. The gate counts
iterations from the model's own count (`self.iter + 1`), as JAX's from its
state. A video net's (N, T, H, W, C) clips reach D and the perceptual
loss as N·T frames (`_flatten_time`, JAX `srgan_model.py:49`).
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):
    def init_training_settings(self, train_opt: dict) -> None:
        super().init_training_settings(train_opt)
        self.net_d = self.build_net("network_d")
        self._d_has_stats = any(isinstance(m, _BatchNorm)
                                for m in self.net_d.modules())
        self.cri_gan = build_loss(train_opt["gan_opt"])
        self.net_d_iters = train_opt.get("net_d_iters", 1)
        self.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
        self.optimizer_d = self.make_optimizer("optim_d", self.net_d)

    # ------------------------------------------------------------- pieces

    @staticmethod
    def _flatten_time(x: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, C) clips → (N·T, H, W, C); images pass."""
        return x.reshape((-1,) + x.shape[2:]) if x.dim() == 5 else x

    def _gan_g_loss(self, output: torch.Tensor, gt: torch.Tensor):
        return self.cri_gan(self.net_d(self._flatten_time(output)), True,
                            is_disc=False)

    def _gan_d_losses(self, output: torch.Tensor, gt: torch.Tensor):
        """(l_d, {name: loss}) of the D step at a detached output."""
        real = self.net_d(self._flatten_time(gt))
        fake = self.net_d(self._flatten_time(output.detach()))
        l_real = self.cri_gan(real, True, is_disc=True)
        l_fake = self.cri_gan(fake, False, is_disc=True)
        return l_real + l_fake, {"l_d_real": l_real, "l_d_fake": l_fake,
                                 "real_score": real.mean(),
                                 "fake_score": fake.mean()}

    def g_losses(self, lq: torch.Tensor, gt: torch.Tensor):
        """(total, {name: loss}, output, None) of the G step."""
        out, _ = self.g_forward(lq)
        losses = {}
        if self.cri_pix is not None:
            losses["l_g_pix"] = self.cri_pix(out, gt)
        if self.cri_perceptual is not None:
            l_p, l_s = self.cri_perceptual(self._flatten_time(out),
                                           self._flatten_time(gt))
            if l_p is not None:
                losses["l_g_percep"] = l_p
            if l_s is not None:
                losses["l_g_style"] = l_s
        losses["l_g_gan"] = self._gan_g_loss(out, gt)
        total = 0.0
        for v in losses.values():
            total = total + v
        return total, losses, out, None

    @torch.no_grad()
    def _refresh_d_stats(self, output: torch.Tensor, gt: torch.Tensor):
        """Move D's running statistics from this step's real and (detached)
        fake batches; the training forwards never read them."""
        if self._d_has_stats:
            for batch in (gt, output):
                self.net_d(self._flatten_time(batch), refresh_stats=True)

    # --------------------------------------------------------------- step

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        """One G (unless gated off) and one D step. Returns the losses,
        detached on the device."""
        lq, gt = self.degrade(batch, generator)
        it = self.iter + 1
        update_g = it % self.net_d_iters == 0 and it > self.net_d_init_iters
        self.net_d.requires_grad_(False)
        if update_g:
            self.optimizer_g.zero_grad()
            total, losses, output, _ = self.g_losses(lq, gt)
            total.backward()
            self.optimizer_g.step()
        else:  # a skipped iteration: no G update, its Adam does not move
            losses = {}
            with torch.no_grad():
                output, _ = self.g_forward(lq)
        self.ema_update(self.net_g_ema, self.net_g, self.ema_decay)

        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        l_d, d_losses = self._gan_d_losses(output.detach(), gt)
        l_d.backward()
        self.optimizer_d.step()
        losses.update(d_losses, l_d=l_d)
        self._refresh_d_stats(output.detach(), gt)
        self.iter += 1
        self.losses = {k: v.detach() for k, v in losses.items()}
        return self.losses

    # -------------------------------------------------------- checkpoints

    def training_state(self) -> dict:
        return dict(super().training_state(),
                    params_d=self.net_d.state_dict(),
                    opt_d=self.optimizer_d.state_dict())

    def load_training_state(self, state: dict) -> None:
        super().load_training_state(state)
        self.net_d.load_state_dict(state["params_d"])
        self.optimizer_d.load_state_dict(state["opt_d"])
