"""upfirdn2d — pad → zero-insertion upsample → FIR filter → downsample.

Port of `image_restoration_tpu/ops/upfirdn.py:33-108`. The JAX package writes
the op as one dilated depthwise convolution; here it is one depthwise
`F.conv2d` (groups=C) on the zero-inserted, padded input. Two semantics to
keep (the JAX module documents both at :13-20):

  * the reference inserts `up-1` zeros AFTER every sample, so the upsampled
    length is `h*up` — the trailing zeros come before the high-side pad;
  * the reference runs a true convolution, so the FIR kernel is flipped
    before the correlation `F.conv2d` computes.

Layout: NHWC in and out; the kernel is shared across channels.

The depthwise conv is `_FIRConv`, whose backward is a
transposed depthwise conv in differentiable ops: autograd's own double
backward of a grouped conv runs one conv per channel group (512 launches
for a 512-channel layer), which made R1's double backward through the
discriminator take seconds on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import DeviceConstants


def make_resample_kernel(k) -> torch.Tensor:
    """Outer-product + normalize a 1D FIR window into a 2D resample kernel."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / torch.sum(k)


# make_resample_kernel(k) * factor2 on a device, built once per (k,
# factor2, device)
_resample_kernel = DeviceConstants(
    lambda k, factor2, device: make_resample_kernel(k).mul_(factor2).to(
        device), maxsize=32)


class _FIRConv(torch.autograd.Function):
    """F.conv2d(x, w, stride, groups=C) for a constant FIR weight w; the
    backward, a transposed depthwise conv, is itself differentiable, so a
    double backward takes one conv per layer."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(w)
        ctx.stride, ctx.in_hw = stride, tuple(x.shape[-2:])
        return F.conv2d(x, w, stride=stride, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        s, (h, wd) = ctx.stride, ctx.in_hw
        kh, kw = w.shape[-2:]
        pad = (h - ((g.shape[-2] - 1) * s + kh),
               wd - ((g.shape[-1] - 1) * s + kw))
        return F.conv_transpose2d(g, w, stride=s, output_padding=pad,
                                  groups=g.shape[1]), None, None


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Apply upfirdn to an NHWC tensor.

    Args:
      x: (N, H, W, C).
      kernel: (kh, kw) FIR filter, shared across channels.
      up/down: integer resampling factors (applied to both spatial dims).
      pad: (pad0, pad1) leading/trailing padding in the upsampled grid;
        negative values crop.

    Returns:
      (N, (H*up + pad0 + pad1 - kh)//down + 1, ..., C) tensor.
    """
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d expects NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    p0, p1 = pad
    xc = x.permute(0, 3, 1, 2)
    if up > 1:
        z = xc.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = xc
        xc = z
    xc = F.pad(xc, (p0, p1, p0, p1))  # negative pads crop
    k = torch.flip(torch.as_tensor(kernel, dtype=x.dtype, device=x.device),
                   (0, 1))
    wgt = k[None, None].expand(c, 1, *k.shape)
    out = _FIRConv.apply(xc, wgt, down)
    return out.permute(0, 2, 3, 1).contiguous()


def upfirdn_upsample(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """UpFirDnUpsample (JAX :75-80)."""
    kernel = _resample_kernel(tuple(kernel), factor ** 2, x.device)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def upfirdn_downsample(x: torch.Tensor, kernel,
                       factor: int = 2) -> torch.Tensor:
    """UpFirDnDownsample (JAX :83-89)."""
    kernel = _resample_kernel(tuple(kernel), 1, x.device)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((p + 1) // 2, p // 2))


def upfirdn_smooth(x: torch.Tensor, kernel, upsample_factor: int = 1,
                   downsample_factor: int = 1,
                   kernel_size: int = 1) -> torch.Tensor:
    """UpFirDnSmooth (JAX :91-108): the smoothing FIR around strided convs;
    `kernel_size` is the kernel size of the adjacent conv."""
    if upsample_factor > 1:
        kernel = _resample_kernel(tuple(kernel), upsample_factor ** 2,
                                  x.device)
        p = kernel.shape[0] - upsample_factor - (kernel_size - 1)
        pad = ((p + 1) // 2 + upsample_factor - 1, p // 2 + 1)
    elif downsample_factor > 1:
        kernel = _resample_kernel(tuple(kernel), 1, x.device)
        p = kernel.shape[0] - downsample_factor + (kernel_size - 1)
        pad = ((p + 1) // 2, p // 2)
    else:
        raise NotImplementedError("need upsample_factor>1 or downsample_factor>1")
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)
