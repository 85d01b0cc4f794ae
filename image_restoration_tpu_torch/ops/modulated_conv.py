"""Convolutions in NHWC and the StyleGAN2 modulated convolution.

Port of `image_restoration_tpu/ops/modulated_conv.py:35-174`: the default
paths, the fused-resample paths (`fused_resample.FUSE_UP` / `FUSE_DOWN`,
read at every call, with `fused_valid_conv` as their inner conv) and the
dynamic-int8 serving mode (`int8_serving`).

Layout: activations NHWC, weights OIHW (the reference checkpoint's layout).
A conv runs on `x.permute(0, 3, 1, 2)`, an NCHW-shaped tensor in
channels_last memory, so no copy is made; cuDNN answers in the same format
and the result permutes back to a contiguous NHWC tensor.

The modulated conv uses the exact rewrite of the JAX package:

    conv(x, W * s_in * d_out) == d_out ⊙ conv(x ⊙ s_in, W)

so the conv is one dense conv shared by the batch, and the demodulation
`d[n,o] = rsqrt(Σ_{ihw} W² s² + eps)` is one einsum, computed in float32.

Dynamic int8 (JAX :35-80): inside `int8_serving()` every conv of this
module runs with per-output-channel int8 weights and a per-tensor int8
activation scale `max|x|/127 + 1e-12` taken on the fly over the whole batch
(so a result depends on what shares its batch, as in JAX), int32 sums, and
a bf16 epilogue `acc→bf16 × (sx·sw→bf16)`. JAX reads its flag once, when a
function is traced; here it is read at every call, so it is a ContextVar:
`Restorer` sets it around its own forward, and neither another restorer
nor another thread sees it. The int8 product is what JAX leaves to XLA's
int8 conv: an explicit NHWC im2col and `torch._int_mm` (int8 × int8 →
int32, exact), K and N padded with zeros to multiples of 8. The FIR
depthwise convs (`upfirdn.py`) stay float, as in JAX; under FUSE_UP /
FUSE_DOWN the FIR is folded into the weight that is quantized.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from . import fused_resample
from .fused_resample import conv_down_fir, conv_up_fir
from .upfirdn import upfirdn_smooth

_INT8_SERVING = contextvars.ContextVar("irt_int8_serving", default=False)


@contextmanager
def int8_serving():
    """Run the convs of this module in dynamic int8 inside the block, in
    this context only (this thread, this task)."""
    token = _INT8_SERVING.set(True)
    try:
        yield
    finally:
        _INT8_SERVING.reset(token)


def _dyn_quant(t: torch.Tensor):
    """Per-tensor int8: s = max|t|/127 + 1e-12 in float32, q = clip(round(t
    / s), ±127), round half to even, true divisions (a division by a Python
    number may become a multiplication by its reciprocal on the GPU)."""
    t32 = t.float()
    m = t32.abs().amax()
    s = m / torch.full_like(m, 127.0) + 1e-12
    q = torch.clamp(torch.round(t32 / s), -127, 127)
    return q.to(torch.int8), s


def _quant_weight(w: torch.Tensor):
    """Per-output-channel int8 of an OIHW weight (axis 0; JAX takes the
    last axis of HWIO)."""
    w32 = w.float()
    m = w32.abs().amax(dim=(1, 2, 3))
    s = m / torch.full_like(m, 127.0) + 1e-12
    q = torch.clamp(torch.round(w32 / s[:, None, None, None]), -127, 127)
    return q.to(torch.int8), s


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding,
            lhs_dilation: int = 1):
    """The (M, K) im2col matrix of NHWC xq for a kh × kw window, in (dy,
    dx, c) order, with JAX's input dilation and padding ((top, bottom),
    (left, right)); M padded to a multiple of 8 and at least 32 and K to a
    multiple of 8, with zeros (`torch._int_mm` takes no smaller shapes on
    the GPU). Returns (matrix, (N, Ho, Wo))."""
    n, h, w, c = xq.shape
    if lhs_dilation > 1:
        d = lhs_dilation
        xd = xq.new_zeros((n, (h - 1) * d + 1, (w - 1) * d + 1, c))
        xd[:, ::d, ::d] = xq
        xq = xd
    (pt, pb), (pl, pr) = padding
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    k = kh * kw * c
    kp, m = _round_up(k, 8), n * ho * wo
    cols = [xp[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    if kp != k:
        cols.append(xp.new_zeros((n, ho, wo, kp - k)))
    a = torch.cat(cols, dim=-1).reshape(m, kp)
    mp = max(_round_up(m, 8), 32)
    if mp != m:
        a = F.pad(a, (0, 0, 0, mp - m))
    return a, (n, ho, wo)


def _int8_conv_sums(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                    padding, lhs_dilation: int = 1) -> torch.Tensor:
    """Exact int32 sums of the NHWC int8 conv of xq with the OIHW int8 wq:
    `lax.conv_general_dilated(xq, wq, stride, padding, lhs_dilation,
    preferred_element_type=int32)`, as one `torch._int_mm` of the im2col
    matrix with the weight, Cout padded to a multiple of 8 with zeros."""
    cout, cin, kh, kw = wq.shape
    a, (n, ho, wo) = _im2col(xq, kh, kw, stride, padding, lhs_dilation)
    k = kh * kw * cin
    b = wq.permute(0, 2, 3, 1).reshape(cout, k)
    b = F.pad(b, (0, a.shape[1] - k, 0, _round_up(cout, 8) - cout))
    # b as (K, Cout) in column-major order, the layout cuBLASLt's int8
    # GEMM takes
    acc = torch._int_mm(a, b.t())
    return acc[:n * ho * wo, :cout].reshape(n, ho, wo, cout)


def _int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding,
               lhs_dilation: int = 1, out_dtype=None) -> torch.Tensor:
    """JAX `_int8_conv` (:70-80) for NHWC x and an OIHW weight."""
    xq, sx = _dyn_quant(x)
    wq, sw = _quant_weight(w)
    acc = _int8_conv_sums(xq, wq, stride, padding, lhs_dilation)
    deq = (sx * sw).to(torch.bfloat16)
    return (acc.float().to(torch.bfloat16) * deq).to(out_dtype or x.dtype)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _no_grouped_int8(groups: int) -> None:
    if groups != 1:
        raise NotImplementedError(
            "dynamic int8 serving takes no grouped convolution")


def fused_valid_conv(xp: torch.Tensor, wc: torch.Tensor,
                     groups: int = 1) -> torch.Tensor:
    """VALID stride-1 conv of the fused-resample paths (JAX :83-90),
    honouring the dynamic-int8 mode."""
    if _INT8_SERVING.get():
        _no_grouped_int8(groups)
        return _int8_conv(xp, wc, 1, ((0, 0), (0, 0)))
    return _nhwc(F.conv2d(xp.permute(0, 3, 1, 2), wc.to(xp.dtype),
                          groups=groups))


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight (torch Conv2d semantics)."""
    if _INT8_SERVING.get():
        _no_grouped_int8(groups)
        return _int8_conv(x, weight, stride,
                          ((padding, padding), (padding, padding)))
    return _nhwc(F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                          stride=stride, padding=padding, groups=groups))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     stride: int = 2) -> torch.Tensor:
    """torch.conv_transpose2d(stride, padding=0) of an NHWC tensor, with the
    same OIHW weight a forward conv would use (JAX :106-124). In int8 it is
    JAX's form: the input-dilated correlation with the flipped kernel, cast
    to x's dtype before it is quantized."""
    if _INT8_SERVING.get():
        kh, kw = weight.shape[2], weight.shape[3]
        return _int8_conv(x, torch.flip(weight, (2, 3)).to(x.dtype), 1,
                          ((kh - 1, kh - 1), (kw - 1, kw - 1)),
                          lhs_dilation=stride)
    return _nhwc(F.conv_transpose2d(x.permute(0, 3, 1, 2),
                                    weight.transpose(0, 1).to(x.dtype),
                                    stride=stride))


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style: torch.Tensor, demodulate: bool = True,
                     sample_mode: str | None = None,
                     smooth_kernel=(1, 3, 3, 1),
                     eps: float = 1e-8) -> torch.Tensor:
    """StyleGAN2 modulated conv.

    Args:
      x: (N, H, W, Cin) activations.
      weight: (Cout, Cin, kh, kw) shared weight, already `1/sqrt(fan_in)`-
        scaled by the caller.
      style: (N, Cin) per-sample modulation.
      demodulate: apply the rsqrt demodulation.
      sample_mode: None | 'upsample' (stride-2 transposed conv + FIR smooth)
        | 'downsample' (FIR smooth + stride-2 conv).
    """
    kh = weight.shape[-2]
    demod = None
    if demodulate:
        # in float32 (float64 stays float64)
        dt = torch.promote_types(weight.dtype, torch.float32)
        wf, sf = weight.to(dt), style.to(dt)
        w_sq = torch.einsum("oihw,ni->no", wf * wf, sf * sf)
        demod = torch.rsqrt(w_sq + eps)  # (N, Cout)

    xs = x * style[:, None, None, :].to(x.dtype)
    if sample_mode == "upsample":
        if fused_resample.FUSE_UP:
            # one subpixel conv with the FIR folded into the weight
            out = conv_up_fir(xs, weight, smooth_kernel,
                              conv_fn=fused_valid_conv)
        else:
            out = conv_transpose2d(xs, weight, stride=2)
            out = upfirdn_smooth(out, smooth_kernel, upsample_factor=2,
                                 kernel_size=kh)
    elif sample_mode == "downsample":
        if fused_resample.FUSE_DOWN:
            out = conv_down_fir(xs, weight, smooth_kernel,
                                conv_fn=fused_valid_conv)
        else:
            xs = upfirdn_smooth(xs, smooth_kernel, downsample_factor=2,
                                kernel_size=kh)
            out = conv2d(xs, weight, stride=2, padding=0)
    else:
        out = conv2d(xs, weight, stride=1, padding=kh // 2)

    if demod is not None:
        out = out * demod[:, None, None, :].to(out.dtype)
    return out
