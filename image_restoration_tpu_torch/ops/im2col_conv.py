"""3×3 stride-1 conv over a pre-padded NHWC input — kernel K3 and its plain
version.

Port of the Pallas kernel `image_restoration_tpu/ops/pallas/im2col_conv.py`
`conv3x3_im2col`: an im2col matrix of K = 9·Cin per output pixel, in (dy,
dx, c) order, contracted with the (3, 3, Cin, Cout) weight reshaped to
(9·Cin, Cout), products and sums in float32, `out_dtype` out:

    out[n, y, x, o] = Σ_{dy, dx, c} x[n, y+dy, x+dx, c] · w[dy, dx, c, o]

`conv3x3_im2col` keeps the JAX signature and its `H % bh == 0` check, so a
caller fails where JAX fails; `bh` sets nothing else here, since the kernel
tiles on its own. K3 is the custom op ``irt::conv3x3_im2col``
(`torch.library`), called the same way as K1 and K2: its CPU impl is
`conv3x3_im2col_plain`, its CUDA impl launches the hand-written kernel
(`csrc/conv3x3_im2col.cu`), an implicit GEMM on the bf16 tensor cores; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

OUT_DTYPES = (torch.bfloat16, torch.float32)
MAX_CIN = 128  # the kernel stages all 9·Cin weight rows in shared memory
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _check(x_padded, weight, bh, out_dtype):
    if x_padded.dim() != 4 or weight.dim() != 4 or weight.shape[:2] != (3, 3):
        raise ValueError(f"x_padded must be (N, H+2, W+2, Cin) and weight "
                         f"(3, 3, Cin, Cout); got {tuple(x_padded.shape)} and "
                         f"{tuple(weight.shape)}")
    if weight.shape[2] != x_padded.shape[3]:
        raise ValueError(f"weight has {weight.shape[2]} input channels, x "
                         f"{x_padded.shape[3]}")
    h = x_padded.shape[1] - 2
    if h < 1 or x_padded.shape[2] < 3:
        raise ValueError(f"x_padded {tuple(x_padded.shape)} is too small")
    if h % bh:
        raise ValueError(f"H={h} must divide by bh={bh}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")


def conv3x3_im2col_plain(x_padded: torch.Tensor, weight: torch.Tensor,
                         bh: int = 8,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3 in plain PyTorch, on any device and for float32 or bf16 inputs:
    nine shifted slices concatenated in (dy, dx, c) order, one float32
    matmul with the weight as (9·Cin, Cout), a cast to `out_dtype`."""
    _check(x_padded, weight, bh, out_dtype)
    n, hp, wp, cin = x_padded.shape
    h, w = hp - 2, wp - 2
    cout = weight.shape[3]
    cols = torch.cat([x_padded[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)
    out = cols.reshape(-1, 9 * cin).float() @ weight.reshape(
        9 * cin, cout).float()
    return out.reshape(n, h, w, cout).to(out_dtype)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ._build import load
            lib = load("conv3x3_im2col")
            lib.conv3x3_im2col.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
            lib.conv3x3_im2col.restype = ctypes.c_int
            lib.conv3x3_im2col_error_string.argtypes = [ctypes.c_int]
            lib.conv3x3_im2col_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_kernel_args(x_padded, weight):
    """What the CUDA impl takes beyond `_check`, read from metadata alone:
    bf16 x and weight on one device, x contiguous, Cin ≤ 128 after padding
    to 16. Returns the padded Cin."""
    if x_padded.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"the conv3x3_im2col kernel takes bfloat16 x and "
                        f"weight, got {x_padded.dtype} and {weight.dtype}")
    if weight.device != x_padded.device:
        raise ValueError(f"weight must be on x's device {x_padded.device}")
    if not x_padded.is_contiguous():
        raise ValueError("the conv3x3_im2col kernel needs a contiguous NHWC x")
    cin_p = -(-x_padded.shape[3] // 16) * 16
    if cin_p > MAX_CIN:
        raise ValueError(f"the conv3x3_im2col kernel takes Cin <= {MAX_CIN}, "
                         f"got {x_padded.shape[3]}")
    return cin_p


@torch.library.custom_op("irt::conv3x3_im2col", mutates_args=(),
                         device_types="cpu")
def conv3x3_im2col_op(x_padded: torch.Tensor, weight: torch.Tensor, bh: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """K3 as a custom op; this CPU impl is the plain version."""
    return conv3x3_im2col_plain(x_padded, weight, bh, out_dtype)


@conv3x3_im2col_op.register_kernel("cuda")
def _conv3x3_im2col_cuda(x_padded, weight, bh, out_dtype):
    return _launch(x_padded, weight, bh, out_dtype)


@conv3x3_im2col_op.register_fake
def _conv3x3_im2col_fake(x_padded, weight, bh, out_dtype):
    _check(x_padded, weight, bh, out_dtype)
    if x_padded.device.type == "cuda":
        _check_kernel_args(x_padded, weight)
    n, hp, wp, _ = x_padded.shape
    return x_padded.new_empty((n, hp - 2, wp - 2, weight.shape[3]),
                              dtype=out_dtype)


def conv3x3_im2col(x_padded: torch.Tensor, weight: torch.Tensor, bh: int = 8,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """(N, H+2, W+2, Cin) pre-padded input, (3, 3, Cin, Cout) weight →
    (N, H, W, Cout) in `out_dtype` (bfloat16 or float32), through the op
    ``irt::conv3x3_im2col``.

    CPU tensors → `conv3x3_im2col_plain`. CUDA tensors → kernel K3, which
    takes bf16 x and weight on one device, x contiguous and 16-byte
    aligned, Cin ≤ 128; Cin is padded to a multiple of 16 and the weight's
    Cout to a multiple of 8 with zeros. Anything else raises.
    `conv3x3_im2col.launches` counts the kernel's launches.
    """
    _check(x_padded, weight, bh, out_dtype)
    if x_padded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_im2col: unsupported device "
                         f"{x_padded.device}")
    return torch.ops.irt.conv3x3_im2col(x_padded, weight, int(bh), out_dtype)


def _launch(x_padded, weight, bh, out_dtype):
    """Check the arguments, pad Cin and Cout, then launch K3 on x's
    stream."""
    _check(x_padded, weight, bh, out_dtype)
    cin_p = _check_kernel_args(x_padded, weight)
    n, hp, wp, cin = x_padded.shape
    cout = weight.shape[3]
    cout_w = -(-cout // 8) * 8
    if cin_p != cin:
        x_padded = F.pad(x_padded, (0, cin_p - cin))
    if (cin_p, cout_w) != (cin, cout):
        weight = F.pad(weight, (0, cout_w - cout, 0, cin_p - cin))
    wmat = weight.reshape(9 * cin_p, cout_w).contiguous()
    if (x_padded.data_ptr() | wmat.data_ptr()) % 16:
        raise ValueError("the conv3x3_im2col kernel needs 16-byte aligned x")
    out = torch.empty((n, hp - 2, wp - 2, cout), dtype=out_dtype,
                      device=x_padded.device)
    lib = _kernel_lib()
    with torch.cuda.device(x_padded.device):
        stream = torch.cuda.current_stream(x_padded.device).cuda_stream
        err = lib.conv3x3_im2col(
            x_padded.data_ptr(), wmat.data_ptr(), out.data_ptr(), n, hp - 2,
            wp - 2, cin_p, cout, cout_w, int(out_dtype == torch.float32),
            stream)
    if err != 0:
        msg = lib.conv3x3_im2col_error_string(err).decode()
        raise RuntimeError(f"conv3x3_im2col launch failed: {msg} ({err})")
    with _count_lock:
        conv3x3_im2col.launches += 1
    return out


conv3x3_im2col.launches = 0
