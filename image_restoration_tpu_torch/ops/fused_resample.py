"""Fused FIR-resample convolutions of the StyleGAN2 up and down paths.

Port of `image_restoration_tpu/ops/fused_resample.py:50-196`. The two-pass
forms are

  upsample:   conv_transpose2d(x, W, stride 2) → upfirdn_smooth(up 2)
  downsample: upfirdn_smooth(down 2) → conv2d(·, W, stride 2)

Both are linear in x, so each composes into ONE dense conv whose kernel is
the conv kernel convolved (full) with the FIR, corr(corr(z, A), B) =
corr(z, A *full B), exactly, borders included. The stride-2 kernel is then
split into its 2×2 phases:

  upsample:   one VALID conv at input resolution with 4·Cout outputs,
              then depth-to-space;
  downsample: space-to-depth, then one VALID conv at output resolution
              over 4·Cin inputs.

Weights are OIHW here (the JAX package's are HWIO), and the flips follow
the port's two-pass path (`modulated_conv.conv_transpose2d` correlates
with the flipped kernel; `upfirdn2d` flips the FIR). JAX builds the
composed kernel tap by tap with `.at[]` updates, which cost nothing inside
`jit`; eagerly that would be dozens of launches per layer, so here the
composition is one conv of the weight with the FIR and the phase split one
pad, reshape and permute: a handful of ops per layer, all differentiable.

`FUSE_UP` / `FUSE_DOWN` are the JAX package's switches, read from
`IRT_FUSE_UP` / `IRT_FUSE_DOWN` when this module is imported; both default
off, as in JAX. The callers (`modulated_conv2d`, `ConvLayer`) read the
attributes at every call, so setting them switches a built net.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .upfirdn import _resample_kernel

FUSE_UP = os.environ.get("IRT_FUSE_UP", "0") == "1"
FUSE_DOWN = os.environ.get("IRT_FUSE_DOWN", "0") == "1"


def _fir_2d(kernel, gain: float, device) -> torch.Tensor:
    """Outer product, normalized, times `gain` (`make_resample_kernel`),
    built once per device (upfirdn's cache)."""
    return _resample_kernel(tuple(kernel), gain, device)


def _compose_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 2D convolution of each (kh, kw) plane of the OIHW kernel `a`
    with the (fh, fw) filter `b`: C[a+u, b+v] += A[a, b]·B[u, v], in
    float32 (float64 stays), as one conv → (O, I, kh+fh−1, kw+fw−1)."""
    o, i, kh, kw = a.shape
    fh, fw = b.shape
    dtype = torch.promote_types(a.dtype, torch.float32)
    planes = a.to(dtype).reshape(o * i, 1, kh, kw)
    c = F.conv2d(planes, torch.flip(b, (0, 1)).to(dtype)[None, None],
                 padding=(fh - 1, fw - 1))
    return c.reshape(o, i, kh + fh - 1, kw + fw - 1)


def _phase_split_up(c: torch.Tensor, pad0: int):
    """The composed stride-2 transposed kernel as 2×2 subpixel phase
    kernels applied to x directly (JAX `_phase_split_up`, :77-105).

    Output phase d reads the taps t ≡ pad0 − d (mod 2) of C; tap j of the
    phase kernel is C[2j + 1 − d] once C is shifted by 1 − pad0 − 2·omin
    (zero taps fill the shift), so the split is a pad, a reshape to (j, 2)
    and a flip of the phase axis. Returns the (4·O, I, J, J) kernel, its
    output channels ordered (dh, dw, o), and x's (low, high) padding.
    """
    o, i, length = c.shape[0], c.shape[1], c.shape[2]
    r = [(pad0 - d) % 2 for d in (0, 1)]
    taps = [(length - r[d] + 1) // 2 for d in (0, 1)]
    off = [(r[d] + d - pad0) // 2 for d in (0, 1)]
    omin = min(off)
    width = max(taps[d] + off[d] - omin for d in (0, 1))
    shift = 1 - pad0 - 2 * omin
    tail = 2 * width - length - shift
    cp = F.pad(c, (shift, tail, shift, tail))
    k = cp.reshape(o, i, width, 2, width, 2).flip(3, 5)
    k = k.permute(3, 5, 0, 1, 2, 4).reshape(4 * o, i, width, width)
    return k, (-omin, width - 1 + omin)


def conv_up_fir(x: torch.Tensor, weight: torch.Tensor, fir=(1, 3, 3, 1),
                conv_fn=None) -> torch.Tensor:
    """Exact fusion of conv_transpose2d(x, weight, stride 2) and
    upfirdn_smooth(upsample_factor=2) into one subpixel conv and a
    depth-to-space. x NHWC, weight OIHW (Cout, Cin, kh, kw).

    `conv_fn(x_padded, w)` is the inner VALID stride-1 conv (NHWC x, OIHW
    w); the default is `F.conv2d` (the dynamic-int8 mode passes
    `modulated_conv.fused_valid_conv`).
    """
    n, h, w_sp, _ = x.shape
    co, kh = weight.shape[0], weight.shape[2]
    f = _fir_2d(fir, 4.0, x.device)   # upfirdn_smooth multiplies by factor²
    p = f.shape[0] - 2 - (kh - 1)
    fir_p0 = (p + 1) // 2 + 1
    # the transposed conv correlates with the flipped weight (padding
    # kh−1), upfirdn with the flipped FIR (padding fir_p0)
    c = _compose_full(torch.flip(weight, (2, 3)), torch.flip(f, (0, 1)))
    k4, (plo, phi) = _phase_split_up(c, (kh - 1) + fir_p0)
    xp = F.pad(x, (0, 0, plo, phi, plo, phi))
    if conv_fn is not None:
        y = conv_fn(xp, k4)
    else:
        y = F.conv2d(xp.permute(0, 3, 1, 2), k4.to(x.dtype)).permute(
            0, 2, 3, 1)
    # (N, H, W, 2, 2, Co) → (N, 2H, 2W, Co)
    y = y.reshape(n, h, w_sp, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w_sp, co)


def conv_down_fir(x: torch.Tensor, weight: torch.Tensor, fir=(1, 3, 3, 1),
                  conv_fn=None, groups: int = 1) -> torch.Tensor:
    """Exact fusion of upfirdn_smooth(downsample_factor=2) and
    conv2d(weight, stride 2, padding 0, groups) into a space-to-depth and
    one VALID conv. x NHWC, weight OIHW (Cout, Cin/groups, kh, kw);
    `conv_fn(x_padded, w, groups=...)` as in `conv_up_fir`. With groups,
    the space-to-depth keeps each group's 4·Cin/groups channels
    together."""
    n, h, w_sp, ci = x.shape
    co, cig, kh = weight.shape[0], weight.shape[1], weight.shape[2]
    f = _fir_2d(fir, 1.0, x.device)
    flen = f.shape[0]
    p = flen - 2 + (kh - 1)
    fir_p0, fir_p1 = (p + 1) // 2, p // 2
    # y[i] = Σ_t x[2i − fir_p0 + t]·C[t], C = W *full flip(FIR)
    c = _compose_full(weight, torch.flip(f, (0, 1)))
    length = c.shape[2]
    out_h = (h + fir_p0 + fir_p1 - flen + 1 - kh) // 2 + 1
    out_w = (w_sp + fir_p0 + fir_p1 - flen + 1 - kh) // 2 + 1
    pad_h = 2 * (out_h - 1) + length - h - fir_p0
    pad_w = 2 * (out_w - 1) + length - w_sp - fir_p0
    pad_h += (h + fir_p0 + pad_h) % 2     # even, for space-to-depth
    pad_w += (w_sp + fir_p0 + pad_w) % 2
    xp = F.pad(x, (0, 0, fir_p0, pad_w, fir_p0, pad_h))
    hp, wp = xp.shape[1] // 2, xp.shape[2] // 2
    # space-to-depth: xp[2m+e, 2n+g, (q, c)] → ph[m, n, (q, e, g, c)]
    # for group q
    ph = xp.reshape(n, hp, 2, wp, 2, groups, cig).permute(0, 1, 3, 5, 2, 4,
                                                          6)
    ph = ph.reshape(n, hp, wp, 4 * ci)
    # kernel: K[o, (e, g, c), jh, jw] = C[o, c, 2jh + e, 2jw + g]
    taps = (length + 1) // 2
    cp = F.pad(c, (0, 2 * taps - length, 0, 2 * taps - length))
    kd = cp.reshape(co, cig, taps, 2, taps, 2).permute(0, 3, 5, 1, 2, 4)
    kd = kd.reshape(co, 4 * cig, taps, taps)
    if conv_fn is not None:
        y = conv_fn(ph, kd, groups=groups)
    else:
        y = F.conv2d(ph.permute(0, 3, 1, 2), kd.to(x.dtype),
                     groups=groups).permute(0, 2, 3, 1)
    return y[:, :out_h, :out_w, :]
