"""HiFaceGAN: the SPADE generator, its LIP encoder and the multi-scale
PatchGAN discriminator, NHWC at the forward.

Port of `image_restoration_tpu/archs/hifacegan_arch.py:25-297` (parity
with basicsr/archs/hifacegan_arch.py and hifacegan_util.py): SPADE
normalization conditioned on the degraded input at every scale, a
local-importance-pooling encoder, and a multi-scale PatchGAN that returns
every group's output for the feature-matching loss. The convs run over
NCHW inside; the SPADE maps stay NHWC and are resized by
`ops.resize.resize(..., "nearest")`, a gather, so they are exact.

Parameters carry BasicSR's names (`head_0.norm_0.mlp_shared.0.weight`,
`ups.3.conv_s.weight`, `to_rgbs.3.bias`, `lip_encoder.model.3.logit.1.
weight`, `discriminator_1.model2.0.0.weight`), and a BasicSR checkpoint
loads strictly: its spectral-norm triples (`weight_orig`, `weight_u`,
`weight_v`) are folded to `W/σ`, σ = uᵀ·W·v in float64, as they are read
(JAX's `fold_spectral_norm`). Like JAX's, the convs train as plain convs:
no spectral normalization runs in the forward. `HiFaceGAN` keeps BasicSR's
unused `fc` and the `to_rgbs` heads of the other phases, so a reference
checkpoint loads; flax builds neither.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..convert.hifacegan_import import fold_spectral_norm
from ..ops.resize import resize
from ..utils.registry import ARCH_REGISTRY


def _lrelu(x, slope=0.2):
    return torch.where(x >= 0, x, x * slope)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """A conv over NCHW with JAX's `conv_kaiming` init (kaiming normal,
    fan-in, gain √2; zero bias), drawn from the generator `build_network`
    passes. A checkpoint's spectral-norm triple folds into `weight` on
    load."""

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / self.weight[0].numel())
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "weight_orig" in state_dict:
            triple = {k: torch.as_tensor(state_dict.pop(prefix + k)).detach()
                      .cpu().numpy()
                      for k in ("weight_orig", "weight_u", "weight_v")}
            state_dict[prefix + "weight"] = torch.from_numpy(
                fold_spectral_norm(triple)["weight"])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _conv(cin, cout, k=3, stride=1, padding=None, bias=True):
    return Conv(cin, cout, k, stride, k // 2 if padding is None else padding,
                bias=bias)


def _instance_norm(x, eps=1e-5):
    """Parameter-free instance norm over NCHW (biased variance)."""
    return F.instance_norm(x, eps=eps)


def _up2(x):
    """nn.Upsample(scale_factor=2): exact nearest ×2 over NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SPADE(nn.Module):
    """Spatially-adaptive normalization (hifacegan_util.py SPADE): the
    parameter-free instance norm, then `normalized·γ + β` with γ, β from
    bias-free 3×3 convs over a shared embedding of width min(C, 128) of
    the nearest-resized segmap."""

    def __init__(self, norm_nc: int, label_nc: int = 3):
        super().__init__()
        nhidden = 128 if norm_nc > 128 else norm_nc
        self.mlp_shared = nn.Sequential(_conv(label_nc, nhidden), nn.ReLU())
        self.mlp_gamma = _conv(nhidden, norm_nc, bias=False)
        self.mlp_beta = _conv(nhidden, norm_nc, bias=False)

    def forward(self, x, segmap):
        """x (N, C, H, W); segmap NHWC at any size."""
        normalized = _instance_norm(x)
        seg = _nchw(resize(segmap, x.shape[2:], "nearest"))
        actv = self.mlp_shared(seg)
        return normalized * self.mlp_gamma(actv) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    """SPADE residual block (hifacegan_util.py SPADEResnetBlock)."""

    def __init__(self, fin: int, fout: int, label_nc: int = 3):
        super().__init__()
        fmid = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = _conv(fin, fmid)
        self.conv_1 = _conv(fmid, fout)
        if self.learned_shortcut:
            self.conv_s = _conv(fin, fout, 1, bias=False)
        self.norm_0 = SPADE(fin, label_nc)
        self.norm_1 = SPADE(fmid, label_nc)
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, label_nc)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut \
            else x
        dx = self.conv_0(_lrelu(self.norm_0(x, seg)))
        dx = self.conv_1(_lrelu(self.norm_1(dx, seg)))
        return xs + dx


class _Affine(nn.Module):
    """InstanceNorm2d(affine=True)'s weight and bias after the
    parameter-free norm."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return _instance_norm(x) * self.weight[:, None, None] + \
            self.bias[:, None, None]


class SimplifiedLIP(nn.Module):
    """Local-importance pooling (hifacegan_util.py SimplifiedLIP):
    logit = 12·sigmoid(IN_affine(conv(x))), out = avg(x·eˡ)/avg(eˡ) over a
    3×3 stride-2 window (the divisors cancel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.logit = nn.Sequential(_conv(channels, channels, bias=False),
                                   _Affine(channels))

    def forward(self, x):
        weight = torch.exp(torch.sigmoid(self.logit(x)) * 12.0)
        return F.avg_pool2d(x * weight, 3, 2, 1) / \
            F.avg_pool2d(weight, 3, 2, 1)


class LIPEncoder(nn.Module):
    """hifacegan_util.py LIPEncoder: conv, IN, ReLU, then n_2xdown ×
    (SimplifiedLIP ↓2 → conv → IN) with a ReLU between stages. `model`
    keeps the reference Sequential's indices (conv at 0; stage i's LIP at
    3 + 4i and conv at 4 + 4i; the norms and ReLUs hold nothing)."""

    def __init__(self, input_nc: int, ngf: int, n_2xdown: int = 5):
        super().__init__()
        layers = [_conv(input_nc, ngf, bias=False), nn.Identity(),
                  nn.Identity()]
        cur = 1
        for i in range(n_2xdown):
            nxt = min(cur * 2, 16)
            layers += [SimplifiedLIP(ngf * cur),
                       _conv(ngf * cur, ngf * nxt), nn.Identity()]
            if i < n_2xdown - 1:
                layers.append(nn.Identity())
            cur = nxt
        self.model = nn.Sequential(*layers)
        self.n_2xdown = n_2xdown

    def forward(self, x):
        """x NCHW → NCHW at 1/2^n_2xdown."""
        h = F.relu(_instance_norm(self.model[0](x)))
        for i in range(self.n_2xdown):
            h = self.model[4 + 4 * i](self.model[3 + 4 * i](h))
            h = _instance_norm(h)
            if i < self.n_2xdown - 1:
                h = F.relu(h)
        return h


@ARCH_REGISTRY.register()
class SPADEGenerator(nn.Module):
    """SPADE decoder (ref hifacegan_arch.py:10-142).

    The reference's signature is accepted in full: `use_vae` and `z_dim`
    are inert (the VAE path is disabled upstream too), the seed resolution
    is the input's /2^5 (JAX's reading of `crop_size`), and `norm_g`
    always resolves to the parameter-free instance norm of the reference's
    one-process path. `scale_ratio` (5, hardcoded in the reference at :28)
    is the number of halvings down to the seed. forward: (N, H, W, 3) →
    (N, H, W, 3) in (−1, 1), with phase = init_train_phase + 1 when
    `is_train`, else 4.
    """

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 use_vae: bool = False, z_dim: int = 256,
                 crop_size: int = 512,
                 norm_g: str = "spectralspadesyncbatch3x3",
                 is_train: bool = True, init_train_phase: int = 3,
                 scale_ratio: int = 5):
        super().__init__()
        nf = num_feat
        self.num_feat, self.scale_ratio = nf, scale_ratio
        self.is_train, self.init_train_phase = is_train, init_train_phase
        self.fc = _conv(num_in_ch, 16 * nf)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        chans = [16 * nf, 8 * nf, 4 * nf, 2 * nf, nf]
        self.ups = nn.ModuleList(SPADEResnetBlock(chans[i], chans[i + 1],
                                                  num_in_ch)
                                 for i in range(4))
        self.to_rgbs = nn.ModuleList(_conv(chans[i + 1], 3)
                                     for i in range(4))

    @property
    def phase(self) -> int:
        return self.init_train_phase + 1 if self.is_train else 4

    def encode(self, x):
        """Nearest-downsample by 2^scale_ratio, then the fc conv (ref
        :62-69); x NHWC → NCHW."""
        h, w = x.shape[1] // 2 ** self.scale_ratio, \
            x.shape[2] // 2 ** self.scale_ratio
        return self.fc(_nchw(resize(x, (h, w), "nearest")))

    def forward(self, x):
        """x: the degraded input (N, H, W, 3), both seed and SPADE map."""
        seg = x
        feat = self.head_0(self.encode(x), seg)
        feat = _up2(feat)
        feat = self.g_middle_1(self.g_middle_0(feat, seg), seg)
        phase = self.phase
        for i in range(phase):
            feat = self.ups[i](_up2(feat), seg)
        out = self.to_rgbs[phase - 1](_lrelu(feat))
        return _nhwc(torch.tanh(out))


@ARCH_REGISTRY.register()
class HiFaceGAN(SPADEGenerator):
    """SPADEGenerator with the learnable LIP encoder (ref :145-166); `fc`
    stays unused, as in the reference."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, **kw):
        super().__init__(num_in_ch, num_feat, **kw)
        self.lip_encoder = LIPEncoder(num_in_ch, num_feat, self.scale_ratio)
        # the encoder ends at num_feat·min(2^scale_ratio, 16) channels:
        # 16·num_feat at the reference's 5 halvings; fewer halvings give
        # head_0 a narrower input (and a learned shortcut), as flax infers
        enc = num_feat * min(2 ** self.scale_ratio, 16)
        if enc != 16 * num_feat:
            self.head_0 = SPADEResnetBlock(enc, 16 * num_feat, num_in_ch)

    def encode(self, x):
        return self.lip_encoder(_nchw(x))


class NLayerDiscriminator(nn.Module):
    """PatchGAN D returning every group's output (ref :225-270): model0 =
    conv (bias) + lrelu; model1 … model{n−1} = conv without bias (spectral
    in the reference, folded on load) + parameter-free instance norm +
    lrelu; model{n} = a 1-channel conv (bias). 4×4 kernels, padding 2."""

    def __init__(self, input_nc: int, n_layers: int = 4,
                 num_feat: int = 64):
        super().__init__()
        self.n_layers = n_layers
        nf = num_feat
        self.model0 = nn.Sequential(_conv(input_nc, nf, 4, 2, 2))
        for i in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if i == n_layers - 1 else 2
            setattr(self, f"model{i}", nn.Sequential(nn.Sequential(
                _conv(prev, nf, 4, stride, 2, bias=False))))
        setattr(self, f"model{n_layers}",
                nn.Sequential(_conv(nf, 1, 4, 1, 2)))

    def forward(self, x) -> List[torch.Tensor]:
        """x NCHW → the n + 1 group outputs, NCHW."""
        h = _lrelu(self.model0[0](x))
        feats = [h]
        for i in range(1, self.n_layers):
            h = _lrelu(_instance_norm(getattr(self, f"model{i}")[0][0](h)))
            feats.append(h)
        feats.append(getattr(self, f"model{self.n_layers}")[0](h))
        return feats


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """Multi-scale PatchGAN (ref :168-259). Its input has num_in_ch +
    num_out_ch channels when `conditional_d` (the caller concatenates
    (lq, img)), else num_in_ch. Between scales: avg_pool(3, 2, 1,
    count_include_pad=False). `norm_d` resolves to the parameter-free
    instance norm of the reference default (spectralinstance).

    forward: (N, H, W, C) → num_d lists of n_layers_d + 1 NHWC maps.
    """

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 conditional_d: bool = True, num_d: int = 2,
                 n_layers_d: int = 4, num_feat: int = 64,
                 norm_d: str = "spectralinstance"):
        super().__init__()
        self.num_d = num_d
        cin = num_in_ch + (num_out_ch if conditional_d else 0)
        for i in range(num_d):
            setattr(self, f"discriminator_{i}",
                    NLayerDiscriminator(cin, n_layers_d, num_feat))

    def forward(self, x):
        h = _nchw(x)
        outs = []
        for i in range(self.num_d):
            outs.append([_nhwc(f) for f in
                         getattr(self, f"discriminator_{i}")(h)])
            if i != self.num_d - 1:
                h = F.avg_pool2d(h, 3, 2, 1, count_include_pad=False)
        return outs
