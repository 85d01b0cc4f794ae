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
in all three.

A fourth epilogue, the kernel's mode 3, is its own op,
``irt::int8_conv3x3_rrdb_stage`` (`int8_conv3x3_rrdb_stage`): one stage conv
of the int8 RRDB chain's widened dense block (`ops/rrdb_quant.py`) with the
block's glue folded in. It starts from "bf16_deq"'s value h and keeps the
block's bf16 slice sums in a running buffer P (N, H, W, 160), channels
[c2 | c3 | c4 | x5], updated in place: stage 0 writes P and the int8 c1;
stages 1–3 add h into P and requantize the next slice through LeakyReLU;
stage 4 adds the x5 slice and the residual t, the block carry where `body`
is given, and requantizes for the next dense block where `rin` is given. A
dense block is five launches and no other kernel; its plain version is
"bf16_deq" followed by the chain's glue op by op, and the two are bit-equal.

K2 is the custom op ``irt::int8_conv3x3_requant``
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
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rrdb_common import lrelu, mul, to_int8

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
            lib.int8_conv3x3_rrdb_stage.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
            lib.int8_conv3x3_rrdb_stage.restype = ctypes.c_int
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


def _check_rrdb_stage(x, weight, deq, bias, p, t, body, rin, stage):
    """What the RRDB stage op takes, read from metadata alone. Returns (nq,
    p_off): the output channels that become the int8 q through LeakyReLU
    (stage 0: Cout − P's channels; stages 1–3: the growth width, Cin; stage
    4: none) and P's channel of output channel 0."""
    _check(x, weight, deq, bias, None, None, 1, "bf16_deq")
    if stage not in range(5):
        raise ValueError(f"stage must be 0…4, got {stage}")
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if p.dtype != torch.bfloat16 or p.dim() != 4 or p.shape[:3] != (n, h, w):
        raise ValueError(f"p must be bfloat16 (N, H, W, C) at x's pixels "
                         f"{(n, h, w)}, got {p.dtype} {tuple(p.shape)}")
    pc = p.shape[3]
    p_off = pc - cout
    nq = cout - pc if stage == 0 else (cin if stage < 4 else 0)
    # the lowest channel of P the stage touches: stage 0 writes from its
    # output channel nq on, the later stages read from channel 0 on
    lo = p_off + nq if stage == 0 else p_off
    if nq < (1 if stage < 4 else 0) or lo < 0 or \
            (0 < stage < 4 and nq >= cout):
        raise ValueError(f"stage {stage}: Cout {cout} does not fit P's {pc} "
                         f"channels and Cin {cin}")
    if stage < 4:
        if t is not None or body is not None or rin is not None:
            raise ValueError("t, body and rin are stage 4's")
        return nq, p_off
    if t is None:
        raise ValueError("stage 4 needs the residual t")
    for name, r in (("t", t), ("body", body)):
        if r is not None and (r.dtype != torch.bfloat16
                              or r.shape != (n, h, w, cout)):
            raise ValueError(f"{name} must be bfloat16 {(n, h, w, cout)}, "
                             f"got {r.dtype} {tuple(r.shape)}")
    if rin is not None and rin.numel() != 1:
        raise ValueError(f"rin must be one value, got {tuple(rin.shape)}")
    return nq, p_off


def int8_conv3x3_rrdb_stage_plain(x: torch.Tensor, weight: torch.Tensor,
                                  deq: torch.Tensor,
                                  bias: torch.Tensor | None,
                                  p: torch.Tensor,
                                  t: torch.Tensor | None = None,
                                  body: torch.Tensor | None = None,
                                  rin: torch.Tensor | None = None,
                                  stage: int = 0):
    """The RRDB stage op in plain PyTorch, on any device: the "bf16_deq"
    stage conv, then the dense block's glue op by op, P updated in place.
    Returns (q, y) as `int8_conv3x3_rrdb_stage` does."""
    nq, p_off = _check_rrdb_stage(x, weight, deq, bias, p, t, body, rin,
                                  stage)
    h = int8_conv3x3_requant_plain(x, weight, deq, bias,
                                   epilogue="bf16_deq")
    if stage == 0:
        p.copy_(h[..., nq:])
        return to_int8(lrelu(h[..., :nq])), None
    mine = p[..., p_off:p_off + h.shape[-1]]
    if stage < 4:
        v = mine[..., :nq] + h[..., :nq]
        mine[..., nq:] += h[..., nq:]
        return to_int8(lrelu(v)), None
    y = (mine + h) + t
    if body is not None:
        y = mul(y, 0.2) + body
    return (None if rin is None else to_int8(y, rin)), y


def _op_outputs(x, q, y):
    """(q, y) as the op returns them: an absent one as an empty tensor of
    its type (a custom op that updates P in place returns a fixed tuple)."""
    return (x.new_empty((0,), dtype=torch.int8) if q is None else q,
            x.new_empty((0,), dtype=torch.bfloat16) if y is None else y)


@torch.library.custom_op("irt::int8_conv3x3_rrdb_stage", mutates_args=("p",),
                         device_types="cpu")
def int8_conv3x3_rrdb_stage_op(x: torch.Tensor, weight: torch.Tensor,
                               deq: torch.Tensor, bias: Optional[torch.Tensor],
                               p: torch.Tensor, t: Optional[torch.Tensor],
                               body: Optional[torch.Tensor],
                               rin: Optional[torch.Tensor],
                               stage: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """K2's mode 3 as a custom op; this CPU impl is the plain version."""
    return _op_outputs(x, *int8_conv3x3_rrdb_stage_plain(
        x, weight, deq, bias, p, t, body, rin, stage))


@int8_conv3x3_rrdb_stage_op.register_kernel("cuda")
def _int8_conv3x3_rrdb_stage_cuda(x, weight, deq, bias, p, t, body, rin,
                                  stage):
    return _op_outputs(x, *_launch_rrdb_stage(x, weight, deq, bias, p, t,
                                              body, rin, stage))


@int8_conv3x3_rrdb_stage_op.register_fake
def _int8_conv3x3_rrdb_stage_fake(x, weight, deq, bias, p, t, body, rin,
                                  stage):
    nq, _ = _check_rrdb_stage(x, weight, deq, bias, p, t, body, rin, stage)
    n, h, w, _ = x.shape
    if stage < 4:
        return _op_outputs(x, x.new_empty((n, h, w, nq), dtype=torch.int8),
                           None)
    shape = (n, h, w, weight.shape[0])
    return _op_outputs(
        x, None if rin is None else x.new_empty(shape, dtype=torch.int8),
        x.new_empty(shape, dtype=torch.bfloat16))


def int8_conv3x3_rrdb_stage(x: torch.Tensor, weight: torch.Tensor,
                            deq: torch.Tensor, bias: torch.Tensor | None,
                            p: torch.Tensor, t: torch.Tensor | None = None,
                            body: torch.Tensor | None = None,
                            rin: torch.Tensor | None = None, *,
                            stage: int):
    """Stage `stage` (0–4) of the int8 RRDB dense block, a SAME conv of x
    (N, H, W, Cin) int8 with weight (Cout, 3, 3, Cin) int8, h = "bf16_deq"'s
    bf16(acc·deq (+ bias)), and the block's glue, through the op
    ``irt::int8_conv3x3_rrdb_stage``. p (N, H, W, 160) bf16 holds the slice
    sums [c2 | c3 | c4 | x5] and is updated in place.

    Returns (q, y). Stages 0–3: q is the next stage's int8 input
    `int8(clip(round(lrelu(v))))` of the slice c_{s+1} (v = h at stage 0,
    P + h after), y None. Stage 4: y = (P[x5] + h) + t, then the block
    carry `y·0.2 + body` where `body` is given; q = int8 of `y·rin` where
    `rin` (a bf16 scalar tensor, the next dense block's 127/s_t) is given,
    else None. Every step rounds to bf16 where the chain's ops do. The op
    itself returns an absent output as an empty tensor.

    CPU tensors → `int8_conv3x3_rrdb_stage_plain`. CUDA tensors → kernel K2
    in mode 3, which needs contiguous tensors on one device, Cin a multiple
    of 32 and Cout of 16; anything else raises. Its launches count in
    `int8_conv3x3_requant.launches`, with K2's others.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv3x3_rrdb_stage: unsupported device "
                         f"{x.device}")
    q, y = torch.ops.irt.int8_conv3x3_rrdb_stage(x, weight, deq, bias, p, t,
                                                 body, rin, int(stage))
    return (None if stage == 4 and rin is None else q,
            None if stage < 4 else y)


def _launch_rrdb_stage(x, weight, deq, bias, p, t, body, rin, stage):
    """Check the arguments, then launch K2's mode 3 on x's stream."""
    nq, p_off = _check_rrdb_stage(x, weight, deq, bias, p, t, body, rin,
                                  stage)
    _check_kernel_args(x, weight, deq, bias, None, 1, "bf16_deq")
    n, h, w, cin = x.shape
    cout, pc = weight.shape[0], p.shape[3]
    if any(a.device != x.device for a in (p, t, body, rin) if a is not None):
        raise ValueError(f"p, t, body and rin must be on x's device "
                         f"{x.device}")
    if cin % CIN_MULTIPLE or cout % 16 or nq % 16 or pc % 8 or p_off % 8:
        raise ValueError(f"the RRDB stage kernel takes Cin a multiple of "
                         f"{CIN_MULTIPLE}, Cout and the int8 slice of 16, "
                         f"and P's channels of 8; got Cin {cin}, Cout "
                         f"{cout}, slice {nq}, P {pc} at {p_off}")
    held = [a for a in (x, weight, p, t, body) if a is not None]
    if not all(a.is_contiguous() for a in held):
        raise ValueError("the RRDB stage kernel needs contiguous x, weight, "
                         "p, t and body")
    if any(a.data_ptr() % 16 for a in held):
        raise ValueError("the RRDB stage kernel needs 16-byte aligned x, "
                         "weight, p, t and body")
    deq, bias, rin = (None if a is None else a.to(torch.bfloat16).contiguous()
                      for a in (deq, bias, rin))
    if stage < 4:
        q = torch.empty((n, h, w, nq), dtype=torch.int8, device=x.device)
        y = None
    else:
        y = torch.empty((n, h, w, cout), dtype=torch.bfloat16,
                        device=x.device)
        q = None if rin is None else torch.empty(
            (n, h, w, cout), dtype=torch.int8, device=x.device)

    def ptr(a):
        return None if a is None else a.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_conv3x3_rrdb_stage(
            x.data_ptr(), weight.data_ptr(), deq.data_ptr(), ptr(bias),
            p.data_ptr(), pc, p_off, int(stage > 0), nq, ptr(q), ptr(t),
            ptr(body), ptr(rin), ptr(y), n, h, w, cin, cout, stream)
    if err != 0:
        msg = lib.int8_conv3x3_error_string(err).decode()
        raise RuntimeError(f"int8_conv3x3_rrdb_stage launch failed: {msg} "
                           f"({err})")
    with _count_lock:
        int8_conv3x3_requant.launches += 1
    return q, y
