"""int8 3×3 conv + requantization epilogue — kernel K2 and its plain version.

Port of the Pallas kernel `image_restoration_tpu/ops/pallas/int8_conv.py`
`int8_conv3x3_requant` and of the layer expression of the int8 SRVGG chain
(`ops/quantized_inference.py:133-141`): nine shifted int8·int8 → int32
products, then a fused epilogue.

The port's form is batched NHWC: x (N, H, W, Cin) int8, weight
(Cout, 3, 3, Cin) int8, and `pad` 0 (the Pallas signature's VALID conv over a
pre-padded input) or 1 (the chain's SAME conv, zero border implied). Three
epilogues:

- ``"f32"``, the Pallas formula: ``h = acc·deq + b`` in float32 (no FMA),
  PReLU(alpha), ``clip(round(h · (127 / s_out)), ±127)``, int8 out;
- ``"bf16"``, the SRVGG chain's formula: deq, b, alpha in bfloat16 (with
  127/s_out folded in), every operation rounded to bfloat16, then round and
  clip, int8 out;
- ``"bf16_deq"``, the int8 RRDB chain's stage conv
  (`image_restoration_tpu/ops/rrdb_quant.py:153-169`): bfloat16 out,
  ``acc.astype(bf16) · deq (+ b)``, each operation rounded to bfloat16; no
  activation, round or clip. The bias is optional (None).

`alpha=None` means no PReLU (conv_last's int8 sink). Rounding is half to even
in all three. K2 is the custom op ``irt::int8_conv3x3_requant``
(`torch.library`), so `torch.export` records it as one node: its CPU impl is
the plain version, its CUDA impl launches the hand-written kernel
(`csrc/int8_conv3x3.cu`); it never falls back from one to the other. The
fake impl checks what needs no data and gives the output's shape and type;
the channel padding and the 16-byte alignment check read data pointers, so
they stay in the CUDA impl. `s_out` is a Python number, a constant of the
engine (the port's chains fold it into deq and b and pass none).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# epilogue → (kernel mode, type of deq/bias/alpha, output type)
EPILOGUES = {"f32": (0, torch.float32, torch.int8),
             "bf16": (1, torch.bfloat16, torch.int8),
             "bf16_deq": (2, torch.bfloat16, torch.bfloat16)}
# the kernel's K step is 32 channels of one tap, and a block keeps all
# 9·Cin rows of its weight slice in shared memory (csrc/int8_conv3x3.cu)
CIN_MULTIPLE = 32
MAX_CIN = 192
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _check(x, weight, deq, bias, alpha, s_out, pad, epilogue):
    if x.dtype != torch.int8 or weight.dtype != torch.int8:
        raise TypeError(f"int8_conv3x3_requant takes int8 x and weight, got "
                        f"{x.dtype} and {weight.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1:3] != (3, 3):
        raise ValueError(f"x must be (N, H, W, Cin) and weight (Cout, 3, 3, "
                         f"Cin); got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    if weight.shape[3] != x.shape[3]:
        raise ValueError(f"weight has {weight.shape[3]} input channels, x "
                         f"{x.shape[3]}")
    cout = weight.shape[0]
    for name, p in (("deq", deq), ("bias", bias), ("alpha", alpha)):
        if p is not None and p.shape != (cout,):
            raise ValueError(f"{name} shape {tuple(p.shape)} != ({cout},)")
    if pad not in (0, 1):
        raise ValueError(f"pad must be 0 or 1, got {pad}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got "
                         f"{epilogue!r}")
    if epilogue == "f32" and s_out is None:
        raise ValueError("the f32 epilogue needs s_out")
    if epilogue == "bf16_deq" and alpha is not None:
        raise ValueError("the bf16_deq epilogue has no activation")
    if epilogue != "bf16_deq" and bias is None:
        raise ValueError(f"the {epilogue} epilogue needs a bias")
    if x.shape[1] + 2 * pad < 3 or x.shape[2] + 2 * pad < 3:
        raise ValueError(f"x {tuple(x.shape)} is too small for a 3×3 conv "
                         f"with pad {pad}")


def int8_conv3x3_requant_plain(x: torch.Tensor, weight: torch.Tensor,
                               deq: torch.Tensor, bias: torch.Tensor | None,
                               alpha: torch.Tensor | None = None,
                               s_out=None, pad: int = 1,
                               epilogue: str = "bf16") -> torch.Tensor:
    """K2 in plain PyTorch, on any device: the conv exactly in float64
    (every partial sum is an integer far below 2**53; rounding the result
    removes any error of the conv algorithm), then the epilogue op by op."""
    _check(x, weight, deq, bias, alpha, s_out, pad, epilogue)
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   weight.permute(0, 3, 1, 2).double(), padding=pad)
    acc = torch.round(acc).permute(0, 2, 3, 1)
    return requant_epilogue(acc, deq, bias, alpha, s_out, epilogue)


def requant_epilogue(acc: torch.Tensor, deq: torch.Tensor,
                     bias: torch.Tensor | None, alpha: torch.Tensor | None,
                     s_out, epilogue: str) -> torch.Tensor:
    """K2's epilogue on integer sums `acc` (..., Cout), op by op."""
    if epilogue == "bf16_deq":
        h = acc.float().bfloat16() * deq.bfloat16()
        return (h if bias is None else h + bias.bfloat16()).contiguous()
    if epilogue == "f32":
        h = acc.float() * deq.float() + bias.float()
        if alpha is not None:
            h = torch.where(h >= 0, h, h * alpha.float())
        # 127/s_out divided once in float32, as the kernel does; a Python
        # scalar, so no host-to-device copy stalls the stream
        ratio = float(np.float32(127.0) / np.float32(s_out))
        h = torch.round(h * ratio)
    else:
        h = acc.float().bfloat16() * deq.bfloat16() + bias.bfloat16()
        if alpha is not None:
            h = torch.where(h >= 0, h, h * alpha.bfloat16())
        h = torch.round(h)
    return torch.clamp(h, -127, 127).to(torch.int8).contiguous()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import load
            lib = load("int8_conv3x3")
            lib.int8_conv3x3_requant.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.int8_conv3x3_requant.restype = ctypes.c_int
            lib.int8_conv3x3_error_string.argtypes = [ctypes.c_int]
            lib.int8_conv3x3_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _pad_channels(t: torch.Tensor, to: int) -> torch.Tensor:
    """Zero channels on the last axis up to `to`."""
    return t if t.shape[-1] == to else F.pad(t, (0, to - t.shape[-1]))


def _check_kernel_args(x, weight, deq, bias, alpha, pad, epilogue):
    """What the CUDA impl takes beyond `_check`, read from metadata alone:
    the parameters on x's device and Cin ≤ 192 after padding to 32."""
    params = [p for p in (weight, deq, bias, alpha) if p is not None]
    if any(p.device != x.device for p in params):
        raise ValueError("weight, deq, bias and alpha must be on x's device "
                         f"{x.device}")
    cin = -(-x.shape[3] // CIN_MULTIPLE) * CIN_MULTIPLE
    if cin > MAX_CIN:
        raise ValueError(f"int8_conv3x3_requant kernel takes at most "
                         f"{MAX_CIN} input channels, got {x.shape[3]}")
    return cin


@torch.library.custom_op("irt::int8_conv3x3_requant", mutates_args=(),
                         device_types="cpu")
def int8_conv3x3_requant_op(x: torch.Tensor, weight: torch.Tensor,
                            deq: torch.Tensor, bias: Optional[torch.Tensor],
                            alpha: Optional[torch.Tensor],
                            s_out: Optional[float], pad: int,
                            epilogue: str) -> torch.Tensor:
    """K2 as a custom op; this CPU impl is the plain version."""
    return int8_conv3x3_requant_plain(x, weight, deq, bias, alpha, s_out,
                                      pad, epilogue)


@int8_conv3x3_requant_op.register_kernel("cuda")
def _int8_conv3x3_requant_cuda(x, weight, deq, bias, alpha, s_out, pad,
                               epilogue):
    return _launch(x, weight, deq, bias, alpha, s_out, pad, epilogue)


@int8_conv3x3_requant_op.register_fake
def _int8_conv3x3_requant_fake(x, weight, deq, bias, alpha, s_out, pad,
                               epilogue):
    _check(x, weight, deq, bias, alpha, s_out, pad, epilogue)
    if x.device.type == "cuda":
        _check_kernel_args(x, weight, deq, bias, alpha, pad, epilogue)
    n, h, w, _ = x.shape
    return x.new_empty((n, h + 2 * pad - 2, w + 2 * pad - 2, weight.shape[0]),
                       dtype=EPILOGUES[epilogue][2])


def int8_conv3x3_requant(x: torch.Tensor, weight: torch.Tensor,
                         deq: torch.Tensor, bias: torch.Tensor | None,
                         alpha: torch.Tensor | None = None, s_out=None,
                         pad: int = 1, epilogue: str = "bf16") -> torch.Tensor:
    """(N, H, W, Cin) int8 → (N, H + 2·pad − 2, W + 2·pad − 2, Cout), int8
    (bfloat16 for the "bf16_deq" epilogue), through the op
    ``irt::int8_conv3x3_requant``.

    CPU tensors → `int8_conv3x3_requant_plain`. CUDA tensors → kernel K2,
    which needs contiguous x and weight on one device; deq, bias and alpha
    are cast to the epilogue's type (float32 or bfloat16). Cin is padded to
    a multiple of 32 with zero channels and zero weights, and may be at most
    192 after that. Anything else raises. `s_out` is a Python number or
    None. `int8_conv3x3_requant.launches` counts the kernel's launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv3x3_requant: unsupported device "
                         f"{x.device}")
    return torch.ops.irt.int8_conv3x3_requant(
        x, weight, deq, bias, alpha, None if s_out is None else float(s_out),
        int(pad), epilogue)


def _launch(x, weight, deq, bias, alpha, s_out, pad, epilogue):
    """Check the arguments, pad Cin, then launch K2 on x's stream."""
    _check(x, weight, deq, bias, alpha, s_out, pad, epilogue)
    cin = _check_kernel_args(x, weight, deq, bias, alpha, pad, epilogue)
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("int8_conv3x3_requant kernel needs contiguous NHWC "
                         "x and (Cout, 3, 3, Cin) weight")
    mode, pdt, out_dt = EPILOGUES[epilogue]
    x = _pad_channels(x, cin)
    weight = _pad_channels(weight, cin)
    if (x.data_ptr() | weight.data_ptr()) % 16:
        raise ValueError("int8_conv3x3_requant kernel needs 16-byte aligned "
                         "x and weight")
    deq, bias, alpha = (None if p is None else p.to(pdt).contiguous()
                        for p in (deq, bias, alpha))
    n, h, w, _ = x.shape
    cout = weight.shape[0]
    out = torch.empty((n, h + 2 * pad - 2, w + 2 * pad - 2, cout),
                      dtype=out_dt, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_conv3x3_requant(
            x.data_ptr(), weight.data_ptr(), deq.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            1.0 if s_out is None else s_out, out.data_ptr(),
            n, h, w, cin, cout, pad, mode, stream)
    if err != 0:
        msg = lib.int8_conv3x3_error_string(err).decode()
        raise RuntimeError(f"int8_conv3x3_requant launch failed: {msg} "
                           f"({err})")
    with _count_lock:
        int8_conv3x3_requant.launches += 1
    return out


int8_conv3x3_requant.launches = 0
