"""GFPGANModel — the production license-plate GAN trainer.

Port of `image_restoration_tpu/models/gfpgan_model.py:69-442` on one device:

  * G losses: L1 pixel, Sobel, the image-pyramid L1 against the out_rgbs
    (its weight becomes 1e-12 from `remove_pyramid_loss` on), VGG
    perceptual + style, and the GAN loss through D;
  * the G update with Adam betas (0, 0.99) (`fix_decoder` leaves the
    `stylegan_decoder` subtree out of the optimizer), then the EMA
    (decay 0.5^(32/10⁴)) every iteration, skip iterations included;
  * the D logistic update, lr·r and betas (0^r, 0.99^r), r = k/(k+1) for
    R1 every k = `net_d_reg_every` iterations;
  * R1 (weight r1/2·k) as `torch.autograd.grad(D(x).sum(), x,
    create_graph=True)`, so its update takes a double backward through D,
    K1's autograd formula included;
  * the `net_d_iters`/`net_d_init_iters` skip iteration: a G forward with
    no G update at all (Adam's moments do not advance);
  * `train.remat`: the G forward under `torch.utils.checkpoint`.

Randomness (the degradation, StyleConv noise) comes from the model's
`torch.Generator` on its device, seeded from `manual_seed`. The component
discriminators (`use_component_loss`) and the identity loss are not ported
yet (ROADMAP item 16); the production config uses neither.

A checkpoint is the training state `ckpt_{iter}.pth` (`resume` reads it)
and `net_g_{iter}.pth` in the reference's {"params", "params_ema"} layout,
which `Restorer(ckpt_path=...)` serves.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..losses import build_loss
from ..losses.losses import r1_penalty
from ..ops.resize import resize
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class GFPGANModel(SRModel):
    def __init__(self, opt: dict, device=None):
        opt = dict(opt)
        net_g_opt = opt["network_g"]
        self._hw = (net_g_opt.get("input_height", 256),
                    net_g_opt.get("input_width", 256))
        if opt.get("use_component_loss") or opt.get("network_d_char"):
            raise NotImplementedError(
                "the component discriminators (use_component_loss) are not "
                "ported yet (ROADMAP item 16)")
        if opt.get("network_identity") is not None:
            raise NotImplementedError(
                "the identity loss (network_identity) is not ported yet "
                "(ROADMAP item 16)")
        super().__init__(opt, device)
        self.log_size = int(math.log2(min(self._hw)))
        self.ratio = self._hw[1] // self._hw[0]
        self.mark = None

    def init_training_settings(self, train_opt: dict) -> None:
        net_g_opt = self.opt["network_g"]
        self.ema_decay = 0.5 ** (32 / (10 * 1000))
        frozen = "stylegan_decoder" if net_g_opt.get("fix_decoder") else None
        self.optimizer_g = self.make_optimizer("optim_g", self.net_g,
                                               frozen_prefix=frozen,
                                               betas=(0.0, 0.99))
        if frozen:
            getattr(self.net_g, frozen).requires_grad_(False)

        self.net_d = self.build_net("network_d")
        pre_d = self.opt["path"].get("pretrain_network_d")
        if pre_d and pre_d.endswith((".pth", ".pt")):
            self.load_pretrain_torch(self.net_d, pre_d)

        self.net_d_iters = train_opt.get("net_d_iters", 1)
        self.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
        self.net_d_reg_every = train_opt.get("net_d_reg_every", 16)
        self.r1_reg_weight = train_opt.get("r1_reg_weight", 10.0)
        ratio = self.net_d_reg_every / (self.net_d_reg_every + 1)
        self.optimizer_d = self.make_optimizer(
            "optim_d", self.net_d, lr_scale=ratio,
            betas=(0.0 ** ratio, 0.99 ** ratio))

        def loss(key):
            return build_loss(train_opt[key]) if train_opt.get(key) else None

        self.cri_pix = loss("pixel_opt")
        self.cri_sobel = loss("sobel_opt")
        self.cri_l1 = loss("L1_opt")
        self.cri_perceptual = loss("perceptual_opt")
        if self.cri_perceptual is not None:
            self.cri_perceptual.to(self.device)
        self.cri_gan = build_loss(train_opt["gan_opt"])
        self.pyramid_loss_weight = train_opt.get("pyramid_loss_weight", 1.0)
        self.remove_pyramid_loss = train_opt.get("remove_pyramid_loss",
                                                 float("inf"))
        self.remat = bool(train_opt.get("remat", False))

    # ------------------------------------------------------------- pieces

    def _pyramid_gt(self, gt):
        """Bilinear GT pyramid at 8, 16, ... (×ratio in width)."""
        return [resize(gt, (2 ** (i + 3), 2 ** (i + 3) * self.ratio),
                       "bilinear") for i in range(self.log_size - 2)]

    def draw_noise(self, generator=None):
        """StyleConv noise maps for one G forward, from `generator` (the
        model's own by default), on the model's device."""
        gen = generator or self.generator
        return [torch.randn(s, generator=gen, device=self.device)
                for s in self.net_g.stylegan_decoder.noise_shapes()]

    def g_forward(self, lq, noise):
        """(output, out_rgbs) of the training G forward with `noise`."""
        def fwd(x):
            out, rgbs = self.net_g(x, return_rgb=True, noise=noise)
            return (out, *rgbs)

        outs = checkpoint(fwd, lq, use_reentrant=False) if self.remat \
            else fwd(lq)
        return outs[0], list(outs[1:])

    def g_losses(self, lq, gt, noise, pyr_w: float):
        """(total, {name: loss}, output) of the G step (JAX `g_loss`)."""
        output, out_rgbs = self.g_forward(lq, noise)
        total = 0.0
        losses = {}
        if self.cri_pix is not None:
            losses["l_g_pix"] = self.cri_pix(output, gt)
        if self.cri_sobel is not None:
            losses["l_g_sobel"] = self.cri_sobel(output, gt)
        if self.cri_l1 is not None and out_rgbs:
            for i, (rgb, pgt) in enumerate(zip(out_rgbs,
                                               self._pyramid_gt(gt))):
                losses[f"l_p_{2 ** (i + 3)}"] = self.cri_l1(rgb, pgt) * pyr_w
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(output, gt)
            if l_percep is not None:
                losses["l_g_percep"] = l_percep
            if l_style is not None:
                losses["l_g_style"] = l_style
        losses["l_g_gan"] = self.cri_gan(self.net_d(output), True,
                                         is_disc=False)
        for v in losses.values():
            total = total + v
        return total, losses, output

    def d_loss(self, output, gt):
        """(l_d, mean real logit, mean fake logit) of the D logistic step."""
        fake = self.net_d(output)
        real = self.net_d(gt)
        l_d = self.cri_gan(real, True, is_disc=True) + \
            self.cri_gan(fake, False, is_disc=True)
        return l_d, real.mean(), fake.mean()

    def r1_loss(self, gt):
        """The weighted R1 penalty at the (normalized) GT batch."""
        weight = self.r1_reg_weight / 2 * self.net_d_reg_every
        return weight * r1_penalty(self.net_d, gt)

    def pyramid_weight(self, current_iter: int) -> float:
        if current_iter < self.remove_pyramid_loss:
            return self.pyramid_loss_weight
        return 1e-12

    # -------------------------------------------------------------- steps

    def _mark(self, part):
        if self.mark is not None:
            self.mark(part)

    def optimize_parameters(self, current_iter: int, batch, generator=None):
        """One G+D step (and R1 on every `net_d_reg_every`-th iteration).
        `batch` holds "gt" (then the degradation runs on the device) or
        "lq" and "gt", numpy or tensors. Returns the losses, detached on
        the device (`self.losses`), so the host does not wait for the step.
        `self.mark`, when set, is called with each part's name as it
        begins and with None after the last (a profiler's hook)."""
        gen = generator or self.generator
        self._mark("degradation")
        lq, gt = self.degrade(batch, gen)
        update_g = (current_iter % self.net_d_iters == 0
                    and current_iter > self.net_d_init_iters)
        noise = self.draw_noise(gen)

        self.net_d.requires_grad_(False)
        if update_g:
            self._mark("g_forward_losses")
            self.optimizer_g.zero_grad()
            total, losses, output = self.g_losses(
                lq, gt, noise, self.pyramid_weight(current_iter))
            self._mark("g_backward")
            total.backward()
            self._mark("g_adam")
            self.optimizer_g.step()
        else:
            self._mark("g_forward")
            losses = {}
            with torch.no_grad():
                output, _ = self.g_forward(lq, noise)
        self._mark("ema")
        self.ema_update(self.net_g_ema, self.net_g, self.ema_decay)

        self._mark("d_step")
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        l_d, real_s, fake_s = self.d_loss(output.detach(), gt)
        l_d.backward()
        self.optimizer_d.step()
        losses.update(l_d=l_d, real_score=real_s, fake_score=fake_s)
        self.iter += 1

        if current_iter % self.net_d_reg_every == 0:
            self._mark("r1")
            self.optimizer_d.zero_grad()
            l_r1 = self.r1_loss(gt)
            l_r1.backward()
            self.optimizer_d.step()
            losses["l_d_r1"] = l_r1
        self._mark(None)
        self.losses = {k: v.detach() for k, v in losses.items()}
        return self.losses

    def _test_out(self, lq):
        return self.net_g_ema(lq, return_rgb=False, randomize_noise=False)[0]

    # -------------------------------------------------------- checkpoints

    def training_state(self) -> dict:
        return dict(super().training_state(),
                    params_d=self.net_d.state_dict(),
                    opt_d=self.optimizer_d.state_dict())

    def load_training_state(self, state: dict) -> None:
        super().load_training_state(state)
        self.net_d.load_state_dict(state["params_d"])
        self.optimizer_d.load_state_dict(state["opt_d"])
