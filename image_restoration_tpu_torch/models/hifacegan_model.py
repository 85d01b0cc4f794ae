"""HiFaceGANModel: SRGANModel with a multi-scale D and feature matching.

Port of `image_restoration_tpu/models/hifacegan_model.py:19-54` (parity with
basicsr/models/hifacegan_model.py): the multi-scale GAN loss over every
scale's last map, the discriminator feature-matching loss (`GANFeatLoss`
over every scale's intermediate maps, the real ones detached), and
SRGANModel's pixel and perceptual terms, G/D alternation and EMA.

Two readings of the JAX model, kept or not:

  * the feature-matching term is read from `train.feature_matching_opt`,
    the name BasicSR and the shipped config use. JAX reads
    `train.feat_opt`, so for the config as written its ×10 term never runs
    there; the port does not copy that fault;
  * D sees the image alone, as JAX's does (JAX initializes D on 3
    channels, models/srgan_model.py:30), not BasicSR's cat(lq, img): the
    model builds `network_d` with `conditional_d` off, whatever the config
    says. A BasicSR D checkpoint (6 input channels) therefore does not
    load into the trainer's D.
"""

from __future__ import annotations

import torch

from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class HiFaceGANModel(SRGANModel):
    def init_training_settings(self, train_opt: dict) -> None:
        self.opt["network_d"] = dict(self.opt["network_d"],
                                     conditional_d=False)
        super().init_training_settings(train_opt)
        feat = train_opt.get("feature_matching_opt")
        self.cri_feat = build_loss(feat) if feat else None

    def _gan_g_loss(self, output: torch.Tensor, gt: torch.Tensor):
        fake_feats = self.net_d(output)
        loss = self.cri_gan(fake_feats, True, is_disc=False)
        if self.cri_feat is not None:
            loss = loss + self.cri_feat(fake_feats, self.net_d(gt.detach()))
        return loss

    def _gan_d_losses(self, output: torch.Tensor, gt: torch.Tensor):
        real = self.net_d(gt)
        fake = self.net_d(output.detach())
        l_real = self.cri_gan(real, True, is_disc=True)
        l_fake = self.cri_gan(fake, False, is_disc=True)
        return l_real + l_fake, {"l_d_real": l_real, "l_d_fake": l_fake,
                                 "real_score": real[-1][-1].mean(),
                                 "fake_score": fake[-1][-1].mean()}
