"""Modulated deformable convolution (DCNv2), EDVR's alignment op.

Port of `image_restoration_tpu/ops/deform_conv.py:33`. JAX writes it as XLA
gathers and one einsum, not as a Pallas kernel, and the port keeps that
form in plain PyTorch: each of the K taps is sampled bilinearly by four row
gathers (`index_select` of a Cin/g-channel row of the NHWC map, one per
corner), weighted by the bilinear factors and the mask, and the samples of
all taps and groups meet the weight in one matmul over (g·K·Cin/g), then
the bias. Gradients come from autograd (a gather's backward is an
index_add, atomic on the card, so its sums have no fixed order there).

Layouts: x (N, H, W, Cin); offset (N, Ho, Wo, 2·K·g) in the reference's
channel order, per deformable group 2K channels with tap t's (y, x) at
(2t, 2t + 1) (`DCNv2Pack` passes cat(o1, o2) straight through, so a group's
view crosses the o1/o2 boundary: docs/PARITY.md:59-61); mask (N, Ho, Wo,
K·g); weight (Cout, Cin, kh, kw), the reference's layout. A tap outside
[0, H−1]×[0, W−1] reads zero, corner by corner.
"""

from __future__ import annotations

from typing import Optional

import torch


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1,
                          dilation: int = 1, deformable_groups: int = 1,
                          max_offset: Optional[int] = None) -> torch.Tensor:
    """(N, Ho, Wo, Cout). `max_offset=R` clamps every offset to ±R before
    sampling: the meaning of JAX's windowed path (`_mdc_windowed`, `:109`),
    computed by the same exact gather."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    k, g = kh * kw, deformable_groups
    if cin % g:
        raise ValueError(f"cin={cin} not divisible by groups={g}")
    cpg = cin // g
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev = x.device
    pos_dtype = torch.float32 if x.dtype != torch.float64 else x.dtype

    off = offset.to(pos_dtype).reshape(n, ho, wo, g, k, 2)
    if max_offset is not None:
        off = off.clamp(-max_offset, max_offset)
    ar = torch.arange(k, device=dev)
    ky = (ar // kw * dilation).to(pos_dtype)
    kx = (ar % kw * dilation).to(pos_dtype)
    oy = torch.arange(ho, device=dev, dtype=pos_dtype) * stride - padding
    ox = torch.arange(wo, device=dev, dtype=pos_dtype) * stride - padding
    # sampling positions (n, ho, wo, g, k)
    sy = oy[:, None, None, None] + ky + off[..., 0]
    sx = ox[None, :, None, None] + kx + off[..., 1]
    y0, x0 = sy.floor(), sx.floor()
    fy, fx = sy - y0, sx - x0
    m = 1.0 if mask is None else mask.to(pos_dtype).reshape(n, ho, wo, g, k)

    # a row of the map per (pixel, group): row ((n·H + y)·W + x)·g + group
    rows = x.reshape(n * h * w * g, cpg)
    base = (torch.arange(n, device=dev) * (h * w * g)).view(n, 1, 1, 1, 1) \
        + torch.arange(g, device=dev).view(1, 1, 1, g, 1)
    samples = 0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = base + (yi.clamp(0, h - 1).long() * w
                      + xi.clamp(0, w - 1).long()) * g
        vals = rows.index_select(0, idx.reshape(-1))
        coef = (wgt * inside * m).to(x.dtype).reshape(-1, 1)
        samples = samples + vals * coef
    # (n·ho·wo, g·K·cpg) @ (g·K·cpg, cout): weight[o, g·cpg + c, t] at
    # row (g, t, c)
    wmat = weight.to(x.dtype).reshape(cout, g, cpg, k).permute(1, 3, 2, 0)
    out = samples.reshape(n * ho * wo, g * k * cpg) @ wmat.reshape(-1, cout)
    out = out.reshape(n, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
