"""Plain PyTorch reference of GFPGANv1OCR and of the uint8 restore around it.

Written from the published architecture: GFPGAN's `GFPGANv1` (a UNet
encoder, a style code, SFT condition branches and a StyleGAN2 decoder)
with the plate fork's rectangle changes, and BasicSR's StyleGAN2 blocks
(`upfirdn2d_native`, `ModulatedConv2d` with per-sample grouped weights,
`ToRGB`, `ConvLayer`, `ResBlock`). NCHW, one `torch.nn.functional` call per
step, no fused ops and no kernels. Nothing here imports the measured
program: the parameters are a dict of tensors under the reference
checkpoint's names, which `schema` lists with the seeded distribution the
benchmark draws each one from.

Departures from the published code, each one the served forward's:
  * no noise is injected (the served forward passes no noise, and the
    benchmark draws every noise strength as 0);
  * the UNet's `toRGB` pyramid is held but not run (`return_rgb=False`);
  * the ×2 bilinear upsample of `ConvUpLayer` is
    `F.interpolate(align_corners=False)`, which equals cv2's INTER_LINEAR
    at an exact factor of 2 (half-pixel centres, border replicate).

`restore_u8` is `Restorer.restore_batch_u8`'s contract: RGB uint8 in,
/255, (x − 0.5)/0.5, the forward, clip to [−1, 1], rescale, RGB → BGR,
round, uint8 out. It runs in blocks of images so that it fits beside
nothing else, in float32 with TF32 off, or in the dtype given (the
control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
FIR = (1.0, 3.0, 3.0, 1.0)
# the decoder's toRGB weights and biases are drawn narrow: with N(0, 1)
# weights its output has a std of ≈ 2.5 and more than half of it clips;
# at these the output lies mostly inside [−1, 1] (the config's `assumed`)
TO_RGB_STD = 0.1
TO_RGB_BIAS_STD = 0.02


@contextlib.contextmanager
def full_fp32():
    """float32 convs and matmuls without TF32, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ------------------------------------------------------------ sizes

def log_size(net: dict) -> int:
    return int(math.log2(min(net["input_width"], net["input_height"])))


def unet_channels(net: dict) -> Dict[int, int]:
    n, cm = net.get("narrow", 1.0) * 0.5, net["channel_multiplier"]
    return {4: int(512 * n), 8: int(512 * n), 16: int(512 * n),
            32: int(512 * n), 64: int(256 * cm * n), 128: int(128 * cm * n),
            256: int(64 * cm * n), 512: int(32 * cm * n),
            1024: int(16 * cm * n)}


def decoder_channels(net: dict) -> Dict[int, int]:
    n, cm = net.get("narrow", 1.0), net["channel_multiplier"]
    return {4: int(512 * n), 8: int(512 * n), 16: int(512 * n),
            32: int(512 * n), 64: int(256 * cm * n), 128: int(128 * cm * n),
            256: int(64 * cm * n), 512: int(32 * cm * n),
            1024: int(16 * cm * n)}


# ------------------------------------------------------------ schema

def schema(net: dict) -> List[Tuple[str, tuple, float, float]]:
    """[(name, shape, mean, std)] of every parameter, in a fixed order."""
    if not (net.get("input_is_latent") and net.get("different_w")):
        raise NotImplementedError("the reference serves input_is_latent "
                                  "and different_w, as PRODUCTION_GFPGAN")
    out: list = []

    def w(name, *shape, std=1.0):
        out.append((name, tuple(shape), 0.0, std))

    def b(name, n, mean=0.0):
        out.append((name, (n,), mean, 0.1))

    def conv_layer(name, cin, cout, k, down=False, bias=True, act=True):
        i = 1 if down else 0
        w(f"{name}.{i}.weight", cout, cin, k, k)
        if bias and not act:
            b(f"{name}.{i}.bias", cout)
        if act and bias:
            b(f"{name}.{i + 1}.bias", cout)

    def conv_up(name, cin, cout, k, bias=True, act=True):
        w(f"{name}.weight", cout, cin, k, k)
        if bias and not act:
            b(f"{name}.bias", cout)
        if act and bias:
            b(f"{name}.activation.bias", cout)

    def modulated(name, cin, cout, k, nsf, std=1.0):
        w(f"{name}.weight", 1, cout, cin, k, k, std=std)
        w(f"{name}.modulation.weight", cin, nsf)
        b(f"{name}.modulation.bias", cin, mean=1.0)

    ls, ch, dch = log_size(net), unet_channels(net), decoder_channels(net)
    nsf = net["num_style_feat"]
    ratio = net["input_width"] // net["input_height"]
    conv_layer("conv_body_first", 3, ch[2 ** ls], 1)
    cin = ch[2 ** ls]
    for i in range(ls, 2, -1):
        cout = ch[2 ** (i - 1)]
        name = f"conv_body_down.{ls - i}"
        conv_layer(f"{name}.conv1", cin, cin, 3)
        conv_layer(f"{name}.conv2", cin, cout, 3, down=True)
        conv_layer(f"{name}.skip", cin, cout, 1, down=True, bias=False,
                   act=False)
        cin = cout
    conv_layer("final_conv", cin, ch[4], 3)
    cin = ch[4]
    for i in range(3, ls + 1):
        cout = ch[2 ** i]
        name = f"conv_body_up.{i - 3}"
        conv_layer(f"{name}.conv1", cin, cin, 3)
        conv_up(f"{name}.conv2", cin, cout, 3)
        conv_up(f"{name}.skip", cin, cout, 1, bias=False, act=False)
        cin = cout
    for i in range(3, ls + 1):
        w(f"toRGB.{i - 3}.weight", 3, ch[2 ** i], 1, 1)
        b(f"toRGB.{i - 3}.bias", 3)
    n_latent = (ls * 2 - 2) * nsf
    w("final_linear.weight", n_latent, ch[4] * 16 * ratio)
    b("final_linear.bias", n_latent)

    d = "stylegan_decoder"
    w(f"{d}.constant_input.weight", 1, dch[4], 4, 4 * ratio)

    def style_conv(name, cin, cout):
        modulated(f"{name}.modulated_conv", cin, cout, 3, nsf)
        out.append((f"{name}.weight", (1,), 0.0, 0.0))  # noise strength
        b(f"{name}.activate.bias", cout)

    def to_rgb(name, cin):
        out.append((f"{name}.bias", (1, 3, 1, 1), 0.0, TO_RGB_BIAS_STD))
        modulated(f"{name}.modulated_conv", cin, 3, 1, nsf, std=TO_RGB_STD)

    style_conv(f"{d}.style_conv1", dch[4], dch[4])
    to_rgb(f"{d}.to_rgb1", dch[4])
    cin = dch[4]
    for i in range(3, ls + 1):
        cout = dch[2 ** i]
        style_conv(f"{d}.style_convs.{2 * (i - 3)}", cin, cout)
        style_conv(f"{d}.style_convs.{2 * (i - 3) + 1}", cout, cout)
        to_rgb(f"{d}.to_rgbs.{i - 3}", cout)
        cin = cout
    for i in range(3, ls + 1):
        c = ch[2 ** i]
        sft = c if net.get("sft_half") else 2 * c
        for kind, mean in (("scale", 1.0), ("shift", 0.0)):
            name = f"condition_{kind}.{i - 3}"
            w(f"{name}.0.weight", c, c, 3, 3)
            b(f"{name}.0.bias", c)
            w(f"{name}.2.weight", sft, c, 3, 3)
            b(f"{name}.2.bias", sft, mean=mean)
    return out


# ------------------------------------------------------------ blocks

def fir_kernel(factor2: float, dtype, device) -> torch.Tensor:
    k = torch.tensor(FIR, dtype=torch.float32)
    k = k[None, :] * k[:, None]
    return (k / k.sum() * factor2).to(device, dtype)


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """BasicSR's `upfirdn2d_native` (NCHW): zeros after every sample, pad
    (negative crops), a true convolution with the kernel, decimation."""
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    p0, p1 = pad
    out = x.reshape(n * c, h, 1, w, 1)
    out = F.pad(out, [0, up - 1, 0, 0, 0, up - 1])
    out = out.reshape(n * c, 1, h * up, w * up)
    out = F.pad(out, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    out = out[:, :, max(-p0, 0):out.shape[2] - max(-p1, 0),
              max(-p0, 0):out.shape[3] - max(-p1, 0)]
    wk = torch.flip(kernel, [0, 1]).reshape(1, 1, kh, kw)
    out = F.conv2d(out, wk)
    out = out[:, :, ::down, ::down]
    return out.reshape(n, c, out.shape[2], out.shape[3])


def smooth_down(x, k):
    p = 4 - 2 + (k - 1)
    return upfirdn2d(x, fir_kernel(1.0, x.dtype, x.device),
                     pad=((p + 1) // 2, p // 2))


def smooth_up(x, k):
    p = 4 - 2 - (k - 1)
    return upfirdn2d(x, fir_kernel(4.0, x.dtype, x.device),
                     pad=((p + 1) // 2 + 1, p // 2 + 1))


def upsample_skip(x):
    return upfirdn2d(x, fir_kernel(4.0, x.dtype, x.device), up=2,
                     pad=(2, 1))


def fused_lrelu(x, bias):
    return F.leaky_relu(x + bias.reshape(1, -1, 1, 1), 0.2) * SQRT2


def scaled_lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def equal_conv(p, name, x, stride=1, padding=0, bias=True):
    wt = p[f"{name}.weight"]
    scale = 1.0 / math.sqrt(wt[0].numel())
    return F.conv2d(x, wt * scale, p[f"{name}.bias"] if bias else None,
                    stride=stride, padding=padding)


def equal_linear(p, name, x):
    wt = p[f"{name}.weight"]
    return F.linear(x, wt * (1.0 / math.sqrt(wt.shape[1])),
                    p[f"{name}.bias"])


def conv_layer(p, name, x, k, down=False, bias=True, act=True):
    i = 0
    if down:
        x = smooth_down(x, k)
        i = 1
    out = equal_conv(p, f"{name}.{i}", x, stride=2 if down else 1,
                     padding=0 if down else k // 2, bias=bias and not act)
    if act:
        out = fused_lrelu(out, p[f"{name}.{i + 1}.bias"]) if bias \
            else scaled_lrelu(out)
    return out


def conv_up(p, name, x, k, bias=True, act=True):
    out = F.interpolate(x, scale_factor=2, mode="bilinear",
                        align_corners=False)
    wt = p[f"{name}.weight"]
    out = F.conv2d(out, wt / math.sqrt(wt[0].numel()), padding=k // 2)
    if bias and not act:
        out = out + p[f"{name}.bias"].reshape(1, -1, 1, 1)
    if act:
        out = fused_lrelu(out, p[f"{name}.activation.bias"]) if bias \
            else scaled_lrelu(out)
    return out


def res_block(p, name, x):
    out = conv_layer(p, f"{name}.conv1", x, 3)
    out = conv_layer(p, f"{name}.conv2", out, 3, down=True)
    skip = conv_layer(p, f"{name}.skip", x, 1, down=True, bias=False,
                      act=False)
    return (out + skip) / SQRT2


def res_up_block(p, name, x):
    out = conv_layer(p, f"{name}.conv1", x, 3)
    out = conv_up(p, f"{name}.conv2", out, 3)
    skip = conv_up(p, f"{name}.skip", x, 1, bias=False, act=False)
    return (out + skip) / SQRT2


def sft_condition(p, name, x):
    out = equal_conv(p, f"{name}.0", x, padding=1)
    return equal_conv(p, f"{name}.2", scaled_lrelu(out), padding=1)


def modulated_conv(p, name, x, style, demodulate, upsample=False):
    """BasicSR's ModulatedConv2d: a weight per sample, demodulated, run as
    one grouped conv over the batch."""
    b, c, h, w = x.shape
    wt = p[f"{name}.weight"]                       # (1, O, I, k, k)
    _, o, _, k, _ = wt.shape
    s = equal_linear(p, f"{name}.modulation", style)
    weight = wt / math.sqrt(c * k * k) * s.reshape(b, 1, c, 1, 1)
    if demodulate:
        demod = torch.rsqrt(weight.pow(2).sum([2, 3, 4]) + 1e-8)
        weight = weight * demod.reshape(b, o, 1, 1, 1)
    xg = x.reshape(1, b * c, h, w)
    if upsample:
        weight = weight.transpose(1, 2).reshape(b * c, o, k, k)
        out = F.conv_transpose2d(xg, weight, stride=2, groups=b)
        out = out.reshape(b, o, out.shape[2], out.shape[3])
        return smooth_up(out, k)
    out = F.conv2d(xg, weight.reshape(b * o, c, k, k), padding=k // 2,
                   groups=b)
    return out.reshape(b, o, h, w)


def style_conv(p, name, x, style, upsample=False):
    out = modulated_conv(p, f"{name}.modulated_conv", x, style, True,
                         upsample)
    return fused_lrelu(out, p[f"{name}.activate.bias"])


def to_rgb(p, name, x, style, skip=None):
    out = modulated_conv(p, f"{name}.modulated_conv", x, style, False)
    out = out + p[f"{name}.bias"]
    if skip is not None:
        out = out + upsample_skip(skip)
    return out


def decoder(p, net, latent, conditions):
    d = "stylegan_decoder"
    b = latent.shape[0]
    out = p[f"{d}.constant_input.weight"].repeat(b, 1, 1, 1)
    out = style_conv(p, f"{d}.style_conv1", out, latent[:, 0])
    skip = to_rgb(p, f"{d}.to_rgb1", out, latent[:, 1])
    i = 1
    for idx in range(log_size(net) - 2):
        out = style_conv(p, f"{d}.style_convs.{2 * idx}", out, latent[:, i],
                         upsample=True)
        if i < len(conditions):
            if net.get("sft_half"):
                half = out.shape[1] // 2
                out = torch.cat([out[:, :half], out[:, half:] *
                                 conditions[i - 1] + conditions[i]], dim=1)
            else:
                out = out * conditions[i - 1] + conditions[i]
        out = style_conv(p, f"{d}.style_convs.{2 * idx + 1}", out,
                         latent[:, i + 1])
        skip = to_rgb(p, f"{d}.to_rgbs.{idx}", out, latent[:, i + 2], skip)
        i += 2
    return skip


def forward(p: Dict[str, torch.Tensor], net: dict,
            x: torch.Tensor) -> torch.Tensor:
    """Normalized NCHW images → the restored image in (about) [−1, 1]."""
    ls = log_size(net)
    feat = conv_layer(p, "conv_body_first", x, 1)
    skips = []
    for i in range(ls - 2):
        feat = res_block(p, f"conv_body_down.{i}", feat)
        skips.insert(0, feat)
    feat = conv_layer(p, "final_conv", feat, 3)
    style = equal_linear(p, "final_linear", feat.reshape(feat.shape[0], -1))
    style = style.reshape(style.shape[0], -1, net["num_style_feat"])
    conditions = []
    for i in range(ls - 2):
        feat = res_up_block(p, f"conv_body_up.{i}", feat + skips[i])
        conditions.append(sft_condition(p, f"condition_scale.{i}", feat))
        conditions.append(sft_condition(p, f"condition_shift.{i}", feat))
    return decoder(p, net, style, conditions)


@torch.no_grad()
def restore_u8(p: Dict[str, torch.Tensor], net: dict, x_u8: torch.Tensor,
               dtype=torch.float32, block: int = 16) -> torch.Tensor:
    """(N, H, W, 3) RGB uint8 → (N, H, W, 3) BGR uint8, `block` images at a
    time, on x_u8's device."""
    pd = {k: v.to(x_u8.device, dtype) for k, v in p.items()}
    outs = []
    with full_fp32():
        for s in range(0, x_u8.shape[0], block):
            x = x_u8[s:s + block].permute(0, 3, 1, 2).float() / 255.0
            x = ((x - 0.5) / 0.5).to(dtype)
            y = forward(pd, net, x).float().clamp(-1.0, 1.0)
            y = (y + 1.0) / 2.0
            y = torch.flip(y, dims=(1,))
            y = torch.round(y * 255.0).to(torch.uint8)
            outs.append(y.permute(0, 2, 3, 1))
    return torch.cat(outs, 0)
