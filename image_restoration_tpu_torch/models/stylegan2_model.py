"""StyleGAN2Model — generative pretraining of the StyleGAN2 generator.

Port of `image_restoration_tpu/models/stylegan2_model.py`, step for step
(in a `torch.distributed` world the codes and the path-length noise are
drawn for the global batch and cut to each rank's rows):

  * the D logistic step (`wgan_softplus`) on a fake batch and the real one,
    then the G non-saturating step through the updated D, then the EMA
    (decay 0.5^(32/10⁴));
  * R1 every `net_d_reg_every` (16) iterations, weighted
    r1_reg_weight/2 · 16, and the path-length penalty every
    `net_g_reg_every` (4), weighted path_reg_weight · 4, each its own
    optimizer update after the step, as in JAX; `mean_path_length` is part
    of the state;
  * lazy-regularization Adam: lr·r and betas (0^r, 0.99^r) with
    r = k/(k+1) for each network's k.

Two departures from the JAX package, which the reference and the JAX
module's own docstring ask for (ROADMAP Queue 3):

  * style mixing. JAX draws the mixing coin and never uses it; here each
    of the D step, the G step and the path-length step feeds G two codes
    with probability `mixing_prob`, at an `inject_index` drawn uniformly
    from [1, num_latent − 1] (the reference G's own draw);
  * the path batch is max(1, batch // path_batch_shrink); JAX takes
    max(1, path_batch_shrink).

The path-length penalty differentiates through the style MLP that makes
the latents (`losses.g_path_regularize`), so it trains the MLP, as JAX's
does. Random codes, StyleConv noise and the penalty's image noise come from
the model's `torch.Generator` on its device; the mixing coins and indices
from its generator on the host, so the step never waits for the device to
branch. `style_draws` counts the G forwards of each kind by step part.

A checkpoint is the training state `ckpt_{iter}.pth` (`resume` reads it)
and `net_g_{iter}.pth` in the reference's {"params", "params_ema"} layout,
which a `StyleGAN2Generator` loads (`convert.pth.load_pth`).
"""

from __future__ import annotations

import collections

import torch

from ..losses import build_loss
from ..losses.losses import g_path_regularize, r1_penalty
from ..utils.dist_util import check_global_batch, rank_rows
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class StyleGAN2Model(SRModel):
    def init_training_settings(self, train_opt: dict) -> None:
        g_opt = self.opt["network_g"]
        self.num_style_feat = g_opt.get("num_style_feat", 512)
        h = g_opt.get("input_height", g_opt.get("out_size", 256))
        self._hw = (h, g_opt.get("input_width", h))
        self.ema_decay = 0.5 ** (32 / (10 * 1000))
        self.mean_path_length = torch.zeros((), device=self.device)
        self.host_generator = torch.Generator().manual_seed(self.seed)
        self.style_draws = collections.Counter()

        self.net_d = self.build_net("network_d")
        self.cri_gan = build_loss(train_opt["gan_opt"])
        self.r1_reg_weight = train_opt.get("r1_reg_weight", 10.0)
        self.path_reg_weight = train_opt.get("path_reg_weight", 2.0)
        self.path_batch_shrink = train_opt.get("path_batch_shrink", 2)
        self.net_g_reg_every = train_opt.get("net_g_reg_every", 4)
        self.net_d_reg_every = train_opt.get("net_d_reg_every", 16)
        self.mixing_prob = train_opt.get("mixing_prob", 0.9)
        rg = self.net_g_reg_every / (self.net_g_reg_every + 1)
        rd = self.net_d_reg_every / (self.net_d_reg_every + 1)
        self.optimizer_g = self.make_optimizer(
            "optim_g", self.net_g, lr_scale=rg, betas=(0.0 ** rg, 0.99 ** rg))
        self.optimizer_d = self.make_optimizer(
            "optim_d", self.net_d, lr_scale=rd, betas=(0.0 ** rd, 0.99 ** rd))

    # ------------------------------------------------------------- pieces

    def mixing_noise(self, batch: int, generator=None, part: str = "g"):
        """(codes, inject_index) of one G forward: two (batch,
        num_style_feat) codes and an index in [1, num_latent − 1] with
        probability `mixing_prob`, else one code and None. The coin and the
        index come from the host generator, the codes from `generator`."""
        gen = generator or self.generator
        mix = float(torch.rand((), generator=self.host_generator)) \
            < self.mixing_prob
        n = 2 if mix else 1
        codes = [self._rows(torch.randn(
            (batch * self.world, self.num_style_feat), generator=gen,
            device=self.device)) for _ in range(n)]
        index = None
        if mix:
            index = int(torch.randint(1, self.net_g.num_latent, (),
                                      generator=self.host_generator))
        self.style_draws[part, n] += 1
        return codes, index

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a draw for the global batch."""
        return rank_rows(x, x.shape[0], self.rank, self.world)

    def draw_noise(self, generator=None):
        """StyleConv noise maps for one G forward, on the model's device."""
        gen = generator or self.generator
        return [torch.randn(s, generator=gen, device=self.device)
                for s in self.net_g.noise_shapes()]

    def g_forward(self, codes, inject_index, noise):
        return self.net_g(codes, noise=noise, inject_index=inject_index)[0]

    def d_loss(self, fake, real):
        """(l_d, mean real logit, mean fake logit) of the D step."""
        fake_pred = self.net_d(fake)
        real_pred = self.net_d(real)
        l_d = self.cri_gan(real_pred, True, is_disc=True) + \
            self.cri_gan(fake_pred, False, is_disc=True)
        return l_d, real_pred.mean(), fake_pred.mean()

    def g_loss(self, codes, inject_index, noise):
        """The non-saturating G loss through D."""
        fake = self.g_forward(codes, inject_index, noise)
        return self.cri_gan(self.net_d(fake), True, is_disc=False)

    def r1_loss(self, real):
        """The weighted R1 penalty at the real batch."""
        weight = self.r1_reg_weight / 2 * self.net_d_reg_every
        return weight * r1_penalty(self.net_d, real)

    def path_loss(self, codes, inject_index, noise, img_noise):
        """(weighted penalty, mean path length, new running mean): the
        path-length penalty of the latents the style MLP makes from
        `codes`, its gradient kept through the MLP."""
        latents = self.net_g.latent_codes(codes, inject_index=inject_index)

        def fake_fn(lat):
            return self.net_g([lat], input_is_latent=True, noise=noise)[0]

        penalty, path_mean, new_mean = g_path_regularize(
            fake_fn, latents, self.mean_path_length, img_noise)
        weight = self.path_reg_weight * self.net_g_reg_every
        return weight * penalty, path_mean, new_mean

    def path_batch(self, batch: int) -> int:
        """This rank's rows of the path-length batch (the global batch
        shrunk by `path_batch_shrink`)."""
        pb = max(1, batch * self.world // self.path_batch_shrink)
        return check_global_batch(pb, self.world)

    # -------------------------------------------------------------- steps

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        """One D+G step on `batch["gt"]` (numpy or tensor), then R1 and the
        path-length step on their iterations. Returns the losses, detached
        on the device (`self.losses`)."""
        gen = generator or self.generator
        real = self.to_device(batch["gt"])
        b = real.shape[0]

        codes, index = self.mixing_noise(b, gen, "d")
        noise = self.draw_noise(gen)
        with torch.no_grad():
            fake = self.g_forward(codes, index, noise)
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        l_d, real_s, fake_s = self.d_loss(fake, real)
        l_d.backward()
        self.optimizer_d.step()

        codes, index = self.mixing_noise(b, gen, "g")
        noise = self.draw_noise(gen)
        self.net_d.requires_grad_(False)
        self.optimizer_g.zero_grad()
        l_g = self.g_loss(codes, index, noise)
        l_g.backward()
        self.optimizer_g.step()
        self.ema_update(self.net_g_ema, self.net_g, self.ema_decay)
        losses = dict(l_g=l_g, l_d=l_d, real_score=real_s,
                      fake_score=fake_s)
        self.iter += 1

        if current_iter % self.net_d_reg_every == 0:
            self.net_d.requires_grad_(True)
            self.optimizer_d.zero_grad()
            l_r1 = self.r1_loss(real)
            l_r1.backward()
            self.optimizer_d.step()
            losses["l_d_r1"] = l_r1
        if current_iter % self.net_g_reg_every == 0:
            pb = self.path_batch(b)
            codes, index = self.mixing_noise(pb, gen, "path")
            noise = self.draw_noise(gen)
            img_noise = self._rows(torch.randn(
                (pb * self.world, *self._hw, 3), generator=gen,
                device=self.device))
            self.optimizer_g.zero_grad()
            l_path, path_mean, self.mean_path_length = self.path_loss(
                codes, index, noise, img_noise)
            l_path.backward()
            self.optimizer_g.step()
            losses.update(l_g_path=l_path, path_length=path_mean)
        self.losses = {k: v.detach() for k, v in losses.items()}
        return self.losses

    # -------------------------------------------------------- checkpoints

    def training_state(self) -> dict:
        return dict(super().training_state(),
                    params_d=self.net_d.state_dict(),
                    opt_d=self.optimizer_d.state_dict(),
                    mean_path_length=self.mean_path_length)

    def load_training_state(self, state: dict) -> None:
        super().load_training_state(state)
        self.net_d.load_state_dict(state["params_d"])
        self.optimizer_d.load_state_dict(state["opt_d"])
        self.mean_path_length = state["mean_path_length"].to(self.device)
