"""ESRGANModel — the relativistic average GAN.

Port of `image_restoration_tpu/models/esrgan_model.py` (whole), with every
detach where JAX puts a stop-gradient: G's loss compares D(output) with
the mean of a detached D(gt) and D(gt) (detached) with the mean of
D(output) (not detached); D's loss compares each half with the detached
mean of the other, each term weighted ½. In a world the means are the
global batch's (`world_mean`).
"""

from __future__ import annotations

import torch

from ..utils.dist_util import world_mean
from ..utils.registry import MODEL_REGISTRY
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):
    def _gan_g_loss(self, output: torch.Tensor, gt: torch.Tensor):
        real_pred = self.net_d(gt).detach()
        fake_pred = self.net_d(output)
        l_real = self.cri_gan(real_pred - world_mean(fake_pred.mean()),
                              False, is_disc=False)
        l_fake = self.cri_gan(fake_pred - world_mean(real_pred.mean()),
                              True, is_disc=False)
        return (l_real + l_fake) / 2

    def _gan_d_losses(self, output: torch.Tensor, gt: torch.Tensor):
        real_pred = self.net_d(gt)
        fake_pred = self.net_d(output.detach())
        l_real = self.cri_gan(
            real_pred - world_mean(fake_pred.detach().mean()), True,
            is_disc=True) * 0.5
        l_fake = self.cri_gan(
            fake_pred - world_mean(real_pred.detach().mean()), False,
            is_disc=True) * 0.5
        return l_real + l_fake, {"l_d_real": l_real, "l_d_fake": l_fake,
                                 "real_score": real_pred.mean(),
                                 "fake_score": fake_pred.mean()}
