"""GFPGANModel — the production license-plate GAN trainer.

Port of `image_restoration_tpu/models/gfpgan_model.py:69-442` (on one
device, or over a `torch.distributed` world: models/base_model.py):

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
  * `train.remat`: the G forward under `torch.utils.checkpoint`;
  * the char-component discriminators (`use_component_loss` with
    `network_d_char`, JAX :143-184, :285-312, :363-387): 64² `roi_align`
    crops of the batch's ten `char_boxes` through ten Ds — one
    `FacialComponentDiscriminator(groups=10)`, so each pass over the ten
    chars is five K1 launches — giving the per-char vanilla GAN loss and,
    with `comp_style_weight`, the Gram style loss 0.5·L1(gram₀) +
    L1(gram₁) against the GT crops' features; then every iteration one
    Adam update (betas (0.9, 0.99)) of all ten Ds with JAX's loss, vanilla
    on the real crops and `gan_opt`'s on the fake ones. Each char has its
    own D, as in JAX (the reference's G side sends every char to D 1);
  * the identity loss (`network_identity`, JAX :131-141, :226-230,
    :274-283): a frozen ArcFace IResNet embeds the output and the GT, each
    resized (bilinear) to 112² and clamped to [−1, 1]; the loss is
    `L1_opt`'s (or the mean |Δ|) of the two embeddings, the GT's taken
    without gradient, times `identity_weight`.

Randomness (the degradation, StyleConv noise) comes from the model's
`torch.Generator` on its device, seeded from `manual_seed`.

A checkpoint is the training state `ckpt_{iter}.pth` (`resume` reads it;
with components it holds the ten Ds and their Adam, never the frozen
IResNet) and `net_g_{iter}.pth` in the reference's {"params",
"params_ema"} layout, which `Restorer(ckpt_path=...)` serves.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..archs import build_network
from ..convert.iresnet_import import import_iresnet
from ..convert.pth import load_pth
from ..losses import build_loss
from ..losses.losses import r1_penalty
from ..ops.resize import resize
from ..ops.roi_align import roi_align
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel

NUM_CHARS = 10  # per-char component discriminators
CHAR_CROP = 64  # roi_align output size
ID_SIZE = 112   # the identity net's input size


def _gram(x: torch.Tensor) -> torch.Tensor:
    """Gram matrix of NHWC features, / (C·H·W) (JAX `_gram`)."""
    n, h, w, c = x.shape
    f = x.reshape(n, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / (c * h * w)


@MODEL_REGISTRY.register()
class GFPGANModel(SRModel):
    def __init__(self, opt: dict, device=None):
        opt = dict(opt)
        net_g_opt = opt["network_g"]
        self._hw = (net_g_opt.get("input_height", 256),
                    net_g_opt.get("input_width", 256))
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

        self.use_identity = self.opt.get("network_identity") is not None
        if self.use_identity:
            self.net_identity = self.build_net("network_identity")
            pre = self.opt["path"].get("pretrain_network_identity")
            if pre and pre.endswith((".pth", ".pt")):
                import_iresnet(pre, self.net_identity)
            self.net_identity.eval().requires_grad_(False)
            self.identity_weight = train_opt.get("identity_weight", 1.0)

        self.use_facial_disc = bool(self.opt.get("use_component_loss")) \
            and self.opt.get("network_d_char") is not None
        if self.use_facial_disc:
            self.net_d_char = self._build_char_discriminators()
            self.cri_component = build_loss(train_opt["gan_component_opt"])
            self.comp_style_weight = train_opt.get("comp_style_weight", 0)
            self.optimizer_dc = self.make_optimizer(
                "optim_component", self.net_d_char, betas=(0.9, 0.99))

    def _build_char_discriminators(self):
        """The ten char Ds as one grouped module, drawn from the config's
        seed; `pretrain_network_d_char_{i}` loads into D number i."""
        net_opt = dict(self.opt["network_d_char"], groups=NUM_CHARS)
        gen = torch.Generator().manual_seed(self.seed + 7)
        net = build_network(net_opt, gen).to(self.device)
        for i in range(NUM_CHARS):
            pre = self.opt["path"].get(f"pretrain_network_d_char_{i}")
            if pre and pre.endswith((".pth", ".pt")):
                net.load_char(i, load_pth(pre))
                self.logger.info(f"Loaded {pre} into char D {i}")
        return net

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

    @staticmethod
    def char_crops(img, boxes):
        """(B, H, W, 3) and (B, 10, 4) boxes → (10, B, 64, 64, 3)."""
        return roi_align(img, boxes, CHAR_CROP).transpose(0, 1)

    def embed(self, img):
        """The frozen identity net's embedding of an NHWC batch in
        (−1, 1): bilinear to 112², clamped to [−1, 1]."""
        r = resize(img, (ID_SIZE, ID_SIZE), "bilinear").clamp(-1.0, 1.0)
        return self.net_identity(r)

    def identity_loss(self, output, gt):
        """`L1_opt`'s loss (or the mean |Δ|) of the output's and the GT's
        embeddings, the GT's without gradient, times identity_weight."""
        e_out = self.embed(output)
        with torch.no_grad():
            e_gt = self.embed(gt)
        if self.cri_l1 is not None:
            return self.cri_l1(e_out, e_gt) * self.identity_weight
        return (e_out - e_gt).abs().mean() * self.identity_weight

    def component_g_losses(self, output, gt, boxes):
        """(per-char GAN losses (10,), the Gram style loss or None) of the
        G step: each char's D on its fake crop, and with
        `comp_style_weight` the style of its features against the GT
        crop's (taken without gradient)."""
        style = self.comp_style_weight > 0
        logits, fake = self.net_d_char.forward_stacked(
            self.char_crops(output, boxes), return_feats=style)
        l_char = torch.vmap(lambda lg: self.cri_component(
            lg, True, is_disc=False))(logits)
        if not style:
            return l_char, None
        with torch.no_grad():
            _, real = self.net_d_char.forward_stacked(
                self.char_crops(gt, boxes), return_feats=True)

        def style_one(f0, f1, r0, r1):
            return (self.cri_l1(_gram(f0), _gram(r0)) * 0.5
                    + self.cri_l1(_gram(f1), _gram(r1)))

        l_cs = torch.vmap(style_one)(fake[0], fake[1], real[0], real[1])
        return l_char, l_cs.sum() * self.comp_style_weight

    def component_d_losses(self, output, gt, boxes):
        """Per-char D losses (10,): vanilla on the real crop plus `gan_opt`'s
        loss on the fake one (JAX's mix)."""
        fake, _ = self.net_d_char.forward_stacked(
            self.char_crops(output, boxes))
        real, _ = self.net_d_char.forward_stacked(
            self.char_crops(gt, boxes))
        return torch.vmap(lambda r, f: self.cri_component(
            r, True, is_disc=True) + self.cri_gan(f, False, is_disc=True))(
            real, fake)

    def g_losses(self, lq, gt, noise, pyr_w: float, boxes=None):
        """(total, {name: loss}, output) of the G step (JAX `g_loss`);
        `boxes` (B, 10, 4) when the component Ds train."""
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
        if self.use_identity:
            losses["l_identity"] = self.identity_loss(output, gt)
        for v in losses.values():
            total = total + v
        if self.use_facial_disc:
            l_char, l_cs = self.component_g_losses(output, gt, boxes)
            total = total + l_char.sum()
            for i in range(NUM_CHARS):
                losses[f"l_g_gan_char_{i}"] = l_char[i]
            if l_cs is not None:
                total = total + l_cs
                losses["l_g_comp_style_loss"] = l_cs
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
        boxes = None
        if self.use_facial_disc:
            if "char_boxes" not in batch:
                raise KeyError("use_component_loss needs the dataset to "
                               "give 'char_boxes' (crop_components: true)")
            boxes = self.to_device(batch["char_boxes"]).float()
        self._mark("degradation")
        lq, gt = self.degrade(batch, gen)
        update_g = (current_iter % self.net_d_iters == 0
                    and current_iter > self.net_d_init_iters)
        noise = self.draw_noise(gen)

        self.net_d.requires_grad_(False)
        if self.use_facial_disc:
            self.net_d_char.requires_grad_(False)
        if update_g:
            self._mark("g_forward_losses")
            self.optimizer_g.zero_grad()
            total, losses, output = self.g_losses(
                lq, gt, noise, self.pyramid_weight(current_iter), boxes)
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

        if self.use_facial_disc:
            self._mark("char_d_step")
            self.net_d_char.requires_grad_(True)
            self.optimizer_dc.zero_grad()
            per = self.component_d_losses(output.detach(), gt, boxes)
            per.sum().backward()
            self.optimizer_dc.step()
            for i in range(NUM_CHARS):
                losses[f"l_d_char_{i}"] = per[i]
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
        state = dict(super().training_state(),
                     params_d=self.net_d.state_dict(),
                     opt_d=self.optimizer_d.state_dict())
        if self.use_facial_disc:
            state.update(params_dc=self.net_d_char.state_dict(),
                         opt_dc=self.optimizer_dc.state_dict())
        return state

    def load_training_state(self, state: dict) -> None:
        super().load_training_state(state)
        self.net_d.load_state_dict(state["params_d"])
        self.optimizer_d.load_state_dict(state["opt_d"])
        if self.use_facial_disc:
            self.net_d_char.load_state_dict(state["params_dc"])
            self.optimizer_dc.load_state_dict(state["opt_dc"])
