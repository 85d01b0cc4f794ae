"""Fused bias + LeakyReLU × scale — kernel K1 and its plain version.

Port of `image_restoration_tpu/ops/fused_act.py:23-40` and of the Pallas
kernel `ops/pallas/fused_act_kernel.py` `fused_bias_lrelu_pallas`, which
computes ``scale * leaky_relu(x + bias)`` over a channel-last (M, C) view.

K1 is the custom op ``irt::fused_bias_lrelu`` (`torch.library`), so
`torch.export` records it as one node and an exported engine runs the same
kernel as the eager path. Its CPU impl is the plain PyTorch version, its
CUDA impl launches the hand-written kernel (`csrc/fused_bias_act.cu`); it
never falls back from one to the other. Both compute in float32 and round
once to x's dtype, so they agree bit for bit up to the order of float32
operations, which is the same. The fake impl makes the checks that need no
data, so a bad graph fails at export time.

The op's autograd formula is the closed form `g·scale·(x+b ≥ 0 ? 1 :
slope)` written in PyTorch ops, so it is itself differentiable (R1 takes a
double backward).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
from torch import nn

SQRT2 = math.sqrt(2.0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor | None = None,
                           negative_slope: float = 0.2,
                           scale: float = SQRT2) -> torch.Tensor:
    """scale * leaky_relu(x + bias) in plain PyTorch; bias over the last axis.

    The arithmetic is the kernel's: float32 throughout (float64 stays
    float64), one rounding to x's dtype at the end.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    v = x.to(acc)
    if bias is not None:
        v = v + bias.to(x.dtype).to(acc)
    v = torch.where(v >= 0, v, v * negative_slope) * scale
    return v.to(x.dtype)


def fused_leaky_relu_backward(grad: torch.Tensor, x: torch.Tensor,
                              bias: torch.Tensor | None,
                              negative_slope: float = 0.2,
                              scale: float = SQRT2):
    """(grad_x, grad_bias) of `fused_leaky_relu` at (x, bias): the closed
    form g·scale·(x+b ≥ 0 ? 1 : slope), the bias grad summed over every axis
    but the last. Plain PyTorch ops, so autograd differentiates it again."""
    acc = torch.promote_types(x.dtype, torch.float32)
    v = x.to(acc)
    if bias is not None:
        v = v + bias.to(x.dtype).to(acc)
    gs = grad.to(acc) * scale
    gx = torch.where(v >= 0, gs, gs * negative_slope)
    gb = None
    if bias is not None:
        # through the forward's cast of the bias to x's dtype, as autograd
        # of the plain version takes it
        gb = gx.sum(dim=tuple(range(gx.dim() - 1))).to(x.dtype).to(
            bias.dtype)
    return gx.to(x.dtype), gb


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """ScaledLeakyReLU: lrelu(x)·√2 (no bias)."""
    return torch.where(x >= 0, x, x * negative_slope) * SQRT2


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import load
            lib = load("fused_bias_act")
            lib.fused_bias_lrelu.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            lib.fused_bias_lrelu.restype = ctypes.c_int
            lib.fused_bias_lrelu_error_string.argtypes = [ctypes.c_int]
            lib.fused_bias_lrelu_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_kernel_args(x: torch.Tensor, bias: Optional[torch.Tensor]):
    """What K1 takes, read from metadata alone (the fake impl runs it too):
    a contiguous float32 or bfloat16 x on the GPU, a bias of shape (C,)."""
    c = x.shape[-1] if x.dim() else 1
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    if x.device.type != "cuda":
        return
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_leaky_relu kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu kernel needs a contiguous "
                         "channel-last tensor")
    if bias is not None and bias.device != x.device:
        raise ValueError(f"bias on {bias.device}, x on {x.device}")


@torch.library.custom_op("irt::fused_bias_lrelu", mutates_args=(),
                         device_types="cpu")
def fused_bias_lrelu_op(x: torch.Tensor, bias: Optional[torch.Tensor],
                        negative_slope: float, scale: float) -> torch.Tensor:
    """K1 as a custom op; this CPU impl is the plain version."""
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


@fused_bias_lrelu_op.register_kernel("cuda")
def _fused_bias_lrelu_cuda(x, bias, negative_slope, scale):
    return _launch(x, bias, negative_slope, scale)


@fused_bias_lrelu_op.register_fake
def _fused_bias_lrelu_fake(x, bias, negative_slope, scale):
    _check_kernel_args(x, bias)
    return torch.empty_like(x)


def _setup_backward(ctx, inputs, output):
    x, bias, negative_slope, scale = inputs
    ctx.save_for_backward(x, bias)
    ctx.negative_slope, ctx.scale = negative_slope, scale


def _backward(ctx, grad):
    x, bias = ctx.saved_tensors
    gx, gb = fused_leaky_relu_backward(grad, x, bias, ctx.negative_slope,
                                       ctx.scale)
    return gx, gb, None, None


fused_bias_lrelu_op.register_autograd(_backward,
                                      setup_context=_setup_backward)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """scale * leaky_relu(x + bias) over a channel-last tensor (..., C),
    through the op ``irt::fused_bias_lrelu``.

    CPU tensor → `fused_leaky_relu_plain`. CUDA tensor → kernel K1, which
    needs a contiguous float32 or bfloat16 x and a bias of shape (C,) on the
    same device (cast to x's dtype, as the TPU kernel does); anything else
    raises. With grad enabled the op records its autograd node.
    `fused_leaky_relu.launches` counts the kernel's launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
    return torch.ops.irt.fused_bias_lrelu(x, bias, float(negative_slope),
                                          float(scale))


def _launch(x: torch.Tensor, bias: torch.Tensor | None,
            negative_slope: float, scale: float) -> torch.Tensor:
    """Check x and bias, then launch K1 on x's stream."""
    _check_kernel_args(x, bias)
    c = x.shape[-1] if x.dim() else 1
    if bias is not None:
        bias = bias.to(x.dtype)
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_bias_lrelu(
            x.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), x.numel(), c, negative_slope, scale,
            _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        msg = lib.fused_bias_lrelu_error_string(err).decode()
        raise RuntimeError(f"fused_bias_lrelu launch failed: {msg} ({err})")
    with _count_lock:
        fused_leaky_relu.launches += 1
    return out


fused_leaky_relu.launches = 0


class FusedLeakyReLU(nn.Module):
    """Activation with its own per-channel bias (the reference module that
    holds `…activate.bias` / `…activation.bias` / ConvLayer's `N.bias`)."""

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 scale: float = SQRT2):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)


class ScaledLeakyReLU(nn.Module):
    """Bias-free lrelu·√2 (reference `ScaledLeakyReLU`)."""

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return scaled_leaky_relu(x, self.negative_slope)
