"""Loss zoo.

Port of `image_restoration_tpu/losses/losses.py`, NHWC throughout: L1, MSE,
Charbonnier, the Sobel edge losses, weighted TV, VGG perceptual + Gram
style, the GAN losses, GAN feature matching, and the regularizers that
differentiate a network (R1, path length, WGAN-GP) with
`torch.autograd.grad(..., create_graph=True)` where JAX nests `jax.grad`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..utils.device import const_tensor
from ..utils.dist_util import world_mean
from ..utils.registry import LOSS_REGISTRY


def _reduce(x, reduction: str, weight=None):
    if weight is not None:
        x = x * weight
    if reduction == "none":
        return x
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "mean":
        return torch.mean(x)
    raise ValueError(f"unsupported reduction {reduction}")


# ------------------------------------------------------------ elementwise


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kw):
        return self.loss_weight * _reduce(torch.abs(pred - target),
                                          self.reduction, weight)


@LOSS_REGISTRY.register()
class MSELoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kw):
        return self.loss_weight * _reduce((pred - target) ** 2,
                                          self.reduction, weight)


@LOSS_REGISTRY.register()
class CharbonnierLoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 eps: float = 1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None, **kw):
        return self.loss_weight * _reduce(
            torch.sqrt((pred - target) ** 2 + self.eps), self.reduction,
            weight)


# ------------------------------------------------------------- edge losses

# (2, 1, 3, 3): Gx, Gy
_SOBEL = ((((-1, 0, 1), (-2, 0, 2), (-1, 0, 1)),),
          (((1, 2, 1), (0, 0, 0), (-1, -2, -1)),))


def sobel_edge_map(x: torch.Tensor) -> torch.Tensor:
    """sqrt(|Gx| + |Gy|), Gx and Gy summed over the input channels:
    (N, H, W, C) → (N, H, W, 1)."""
    c = x.shape[-1]
    k = const_tensor(_SOBEL, x.dtype, x.device).expand(2, c, 3, 3)
    g = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1)
    return torch.sqrt(torch.abs(g[:, :1]) + torch.abs(g[:, 1:])).permute(
        0, 2, 3, 1)


@LOSS_REGISTRY.register()
class SobelLoss:
    """L1 between Sobel edge maps."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kw):
        e1, e2 = sobel_edge_map(pred), sobel_edge_map(target)
        return self.loss_weight * _reduce(torch.abs(e1 - e2),
                                          self.reduction, weight)


@LOSS_REGISTRY.register()
class WMSELoss:
    """MSE between Sobel edge maps."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kw):
        e1, e2 = sobel_edge_map(pred), sobel_edge_map(target)
        return self.loss_weight * _reduce((e1 - e2) ** 2, self.reduction,
                                          weight)


@LOSS_REGISTRY.register()
class WeightedTVLoss(L1Loss):
    """TV loss with an optional elementwise weight."""

    def __init__(self, loss_weight: float = 1.0):
        super().__init__(loss_weight=loss_weight, reduction="mean")

    def __call__(self, pred, weight=None, **kw):
        wy = None if weight is None else weight[:, :-1, :, :]
        wx = None if weight is None else weight[:, :, :-1, :]
        y_loss = super().__call__(pred[:, :-1, :, :], pred[:, 1:, :, :], wy)
        x_loss = super().__call__(pred[:, :, :-1, :], pred[:, :, 1:, :], wx)
        return y_loss + x_loss


# --------------------------------------------------------- perceptual loss


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, C, C) / (C·H·W), summed in float32."""
    n, h, w, c = feat.shape
    f = feat.reshape(n, h * w, c).float()
    return torch.einsum("nic,nid->ncd", f, f) / (c * h * w)


@LOSS_REGISTRY.register()
class PerceptualLoss:
    """VGG perceptual + Gram style loss.

    Holds its own `VGGFeatureExtractor` (on the CPU until `.to(device)`).
    `vgg_weights_path` names a torchvision vgg19 state_dict `.pth`; without
    it the taps are drawn from a generator seeded with `seed`.
    """

    def __init__(self, layer_weights: Dict[str, float],
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, perceptual_weight: float = 1.0,
                 style_weight: float = 0.0, criterion: str = "l1",
                 vgg_weights_path: Optional[str] = None,
                 compute_dtype: Optional[str] = None, seed: int = 0):
        from ..archs import init_weights
        from ..archs.vgg_arch import VGGFeatureExtractor
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        dtype = {None: None, "bf16": torch.bfloat16,
                 "f32": torch.float32}[compute_dtype]
        self.vgg = VGGFeatureExtractor(
            layer_name_list=tuple(layer_weights.keys()), vgg_type=vgg_type,
            use_input_norm=use_input_norm, range_norm=range_norm,
            dtype=dtype)
        init_weights(self.vgg, torch.Generator().manual_seed(seed))
        if vgg_weights_path:
            self.vgg.load_torchvision(vgg_weights_path)
        self.vgg.eval().requires_grad_(False)

    def to(self, device):
        self.vgg.to(device)
        return self

    def _crit(self, a, b):
        a, b = a.float(), b.float()
        if self.criterion == "l1":
            return torch.mean(torch.abs(a - b))
        if self.criterion in ("l2", "mse"):
            return torch.mean((a - b) ** 2)
        if self.criterion == "fro":
            return torch.linalg.norm(a - b)
        raise ValueError(self.criterion)

    def __call__(self, x, gt):
        fx = self.vgg(x)
        fgt = self.vgg(gt.detach())
        percep, style = None, None
        if self.perceptual_weight > 0:
            percep = sum(self._crit(fx[k], fgt[k]) * w
                         for k, w in self.layer_weights.items())
            percep = percep * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._crit(gram_matrix(fx[k]), gram_matrix(fgt[k]))
                        * w for k, w in self.layer_weights.items())
            style = style * self.style_weight
        return percep, style


# --------------------------------------------------------------- GAN losses


@LOSS_REGISTRY.register()
class GANLoss:
    """vanilla | lsgan | wgan | wgan_softplus | hinge."""

    def __init__(self, gan_type: str, real_label_val: float = 1.0,
                 fake_label_val: float = 0.0, loss_weight: float = 1.0):
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight
        if gan_type not in ("vanilla", "lsgan", "wgan", "wgan_softplus",
                            "hinge"):
            raise NotImplementedError(f"GAN type {gan_type} not implemented")

    def __call__(self, inp, target_is_real: bool, is_disc: bool = False):
        if self.gan_type == "vanilla":
            label = self.real_label_val if target_is_real else \
                self.fake_label_val
            loss = torch.mean(torch.clamp(inp, min=0) - inp * label +
                              torch.log1p(torch.exp(-torch.abs(inp))))
        elif self.gan_type == "lsgan":
            label = self.real_label_val if target_is_real else \
                self.fake_label_val
            loss = torch.mean((inp - label) ** 2)
        elif self.gan_type == "wgan":
            loss = -torch.mean(inp) if target_is_real else torch.mean(inp)
        elif self.gan_type == "wgan_softplus":
            loss = torch.mean(F.softplus(-inp)) if target_is_real else \
                torch.mean(F.softplus(inp))
        else:  # hinge
            if is_disc:
                inp = -inp if target_is_real else inp
                loss = torch.mean(F.relu(1 + inp))
            else:
                loss = -torch.mean(inp)
        if is_disc:
            return loss
        return loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of multi-scale D outputs."""

    def __call__(self, inp, target_is_real, is_disc=False):
        if isinstance(inp, (list, tuple)):
            total = 0.0
            for pred in inp:
                if isinstance(pred, (list, tuple)):
                    pred = pred[-1]
                total = total + super().__call__(pred, target_is_real,
                                                 is_disc)
            return total / len(inp)
        return super().__call__(inp, target_is_real, is_disc)


@LOSS_REGISTRY.register()
class GANFeatLoss:
    """Multi-scale D feature-matching loss."""

    def __init__(self, criterion: str = "l1", loss_weight: float = 1.0,
                 reduction: str = "mean"):
        if criterion == "l1":
            self.crit = L1Loss(1.0, reduction)
        elif criterion in ("l2", "mse"):
            self.crit = MSELoss(1.0, reduction)
        elif criterion == "charbonnier":
            self.crit = CharbonnierLoss(1.0, reduction)
        else:
            raise ValueError(criterion)
        self.loss_weight = loss_weight

    def __call__(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.0
        for i in range(num_d):
            for j in range(len(pred_fake[i]) - 1):
                loss = loss + self.crit(pred_fake[i][j],
                                        pred_real[i][j].detach()) / num_d
        return loss * self.loss_weight


# ------------------------------------------------------------ regularizers


def r1_penalty(d_fn: Callable, real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty E[‖∇_x D(x)‖²]; `d_fn` maps images to logits.
    The input gradient stays in the graph, so the penalty's own gradient is
    a double backward through D."""
    x = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    return torch.mean(torch.sum(grad.reshape(grad.shape[0], -1) ** 2, dim=1))


def g_path_regularize(fake_fn: Callable, latents: torch.Tensor,
                      mean_path_length, noise: torch.Tensor,
                      decay: float = 0.01):
    """StyleGAN2 path-length regularizer. `noise` is a standard normal
    draw of the fake image's shape (the JAX function draws it from a key).
    Returns (penalty, mean path length, new running mean), the last two
    detached.

    The gradient is taken with respect to `latents` as given, and kept in
    the graph: when the latents come from a network (the style MLP), the
    penalty's gradient reaches its parameters, as JAX's does. Only a
    latent tensor without grad is made a leaf that requires it."""
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_(True)
    fake_img = fake_fn(latents)
    h, w = fake_img.shape[1], fake_img.shape[2]
    noise = noise / math.sqrt(h * w)
    (grad,) = torch.autograd.grad((fake_img * noise).sum(), latents,
                                  create_graph=True)
    path_lengths = torch.sqrt(torch.mean(torch.sum(grad ** 2, dim=2), dim=1))
    batch_mean = world_mean(path_lengths.mean())  # the global batch's
    path_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    penalty = torch.mean((path_lengths - path_mean) ** 2)
    return penalty, batch_mean.detach(), \
        torch.as_tensor(path_mean).detach()


def gradient_penalty_loss(d_fn: Callable, real_data: torch.Tensor,
                          fake_data: torch.Tensor, alpha: torch.Tensor,
                          weight=None) -> torch.Tensor:
    """WGAN-GP penalty at the interpolates real + alpha·(fake − real);
    `alpha` (N, 1, 1, 1) is a uniform draw."""
    interp = real_data + alpha * (fake_data - real_data)
    x = interp.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    if weight is not None:
        grad = grad * weight
    norm = torch.sqrt(torch.sum(grad.reshape(grad.shape[0], -1) ** 2, dim=1)
                      + 1e-12)
    loss = torch.mean((norm - 1.0) ** 2)
    if weight is not None:
        loss = loss / torch.mean(weight)
    return loss
