"""Convolutions in NHWC and the StyleGAN2 modulated convolution.

Port of `image_restoration_tpu/ops/modulated_conv.py:93-174` (default paths
only: the fused-resample and dynamic-int8 modes are not ported yet).

Layout: activations NHWC, weights OIHW (the reference checkpoint's layout).
A conv runs on `x.permute(0, 3, 1, 2)`, an NCHW-shaped tensor in
channels_last memory, so no copy is made; cuDNN answers in the same format
and the result permutes back to a contiguous NHWC tensor.

The modulated conv uses the exact rewrite of the JAX package:

    conv(x, W * s_in * d_out) == d_out ⊙ conv(x ⊙ s_in, W)

so the conv is one dense conv shared by the batch, and the demodulation
`d[n,o] = rsqrt(Σ_{ihw} W² s² + eps)` is one einsum, computed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .upfirdn import upfirdn_smooth


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NHWC conv with an OIHW weight (torch Conv2d semantics)."""
    return _nhwc(F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                          stride=stride, padding=padding))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     stride: int = 2) -> torch.Tensor:
    """torch.conv_transpose2d(stride, padding=0) of an NHWC tensor, with the
    same OIHW weight a forward conv would use (JAX :106-124)."""
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
        w32 = weight.float()
        s32 = style.float()
        w_sq = torch.einsum("oihw,ni->no", w32 * w32, s32 * s32)
        demod = torch.rsqrt(w_sq + eps)  # (N, Cout)

    xs = x * style[:, None, None, :].to(x.dtype)
    if sample_mode == "upsample":
        out = conv_transpose2d(xs, weight, stride=2)
        out = upfirdn_smooth(out, smooth_kernel, upsample_factor=2,
                             kernel_size=kh)
    elif sample_mode == "downsample":
        xs = upfirdn_smooth(xs, smooth_kernel, downsample_factor=2,
                            kernel_size=kh)
        out = conv2d(xs, weight, stride=2, padding=0)
    else:
        out = conv2d(xs, weight, stride=1, padding=kh // 2)

    if demod is not None:
        out = out * demod[:, None, None, :].to(out.dtype)
    return out
