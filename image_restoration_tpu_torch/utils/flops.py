"""Matmul and convolution FLOP counting of eager PyTorch calls.

Port of `image_restoration_tpu/utils/flops.py` (`count_flops` :132, which
walks a jaxpr): here the counting is `torch.utils.flop_counter`'s.
`count_flops(fn, *args)` runs `fn` once under a `FlopCounterMode` and,
beside it, a dispatch mode that files each counted call under the port's
own signature key, `op[in0,in1->out]` (shapes joined by x, PyTorch's NCHW
for convolutions where JAX's keys show NHWC). Everything `fn` runs is
counted, a backward it takes included.

Counts are 2·MACs: `mm`/`addmm`/`bmm`/`baddbmm` as matrix products, every
convolution (grouped and depthwise divide the contraction by the groups)
and its backward as convolutions. Elementwise and reduction work is not
counted, as in JAX. An eager call runs one branch, so `flags` stays empty
where JAX flags a `cond` (max branch) or a `while` (counted once).

Where the two packages decompose an op differently the counts differ. The
one difference on the GFPGAN and StyleGAN2 nets is the stride-2
transposed conv of each upsampling layer: JAX writes it as a conv with
lhs dilation and counts 2·N·Ho·Wo·Cout·Cin·k² over its (2H+1)² output,
the inserted zeros included, where PyTorch's formula counts the MACs the
transposed conv does, 2·N·H·W·Cin·Cout·k². `dilation_extra` gives that
difference from a count's `top_shapes`: on a PRODUCTION_GFPGAN forward at
bs 1 it is 12.76 of JAX's 49.65 GFLOP (tests/test_torch_aux_utils.py holds
port + extra = JAX exactly on a narrow GFPGANv1OCR).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "_scaled_mm"}


def _shape(x) -> str:
    return "x".join(map(str, getattr(x, "shape", ())))


def _first_tensor(out):
    if isinstance(out, (tuple, list)):
        return next((o for o in out if hasattr(o, "shape")), None)
    return out


class _BySignature(TorchDispatchMode):
    """Files the flops of every counted call under its signature key."""

    def __init__(self):
        super().__init__()
        self.by_shape: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            tensors = [a for a in args if hasattr(a, "shape")][:2]
            sig = (f"{func._overloadpacket.__name__}["
                   f"{','.join(_shape(t) for t in tensors)}"
                   f"->{_shape(_first_tensor(out))}]")
            self.by_shape[sig] = self.by_shape.get(sig, 0.0) + flops
        return out


def dilation_extra(top_shapes) -> float:
    """The FLOPs JAX's count adds over this one for the transposed convs
    among `top_shapes` (pass top=a large number to see every call): each
    such call's count times (Ho·Wo / (H·W) − 1)."""
    extra = 0.0
    for sig, flops in top_shapes:
        m = re.match(r"convolution\[\d+x\d+x(\d+)x(\d+),[^-]*->"
                     r"\d+x\d+x(\d+)x(\d+)\]", sig)
        if m and int(m[3]) > int(m[1]):
            ho_wo, h_w = int(m[3]) * int(m[4]), int(m[1]) * int(m[2])
            extra += flops * (ho_wo / h_w - 1)
    return extra


def count_flops(fn, *args, top: int = 12, **kwargs) -> Dict[str, Any]:
    """Count the matmul and convolution FLOPs of `fn(*args, **kwargs)`.

    Returns {total, matmul, conv, flags, top_shapes: [(sig, flops), ...]},
    the dict JAX's `count_flops` returns."""
    with FlopCounterMode(display=False) as counter, _BySignature() as sigs:
        fn(*args, **kwargs)
    acc = {"matmul": 0.0, "conv": 0.0}
    for op, flops in counter.get_flop_counts().get("Global", {}).items():
        name = getattr(op, "__name__", str(op))
        acc["matmul" if name in _MATMUL else "conv"] += float(flops)
    top_shapes = sorted(sigs.by_shape.items(), key=lambda kv: -kv[1])[:top]
    total = acc["matmul"] + acc["conv"]
    assert math.isclose(total, sum(sigs.by_shape.values()), rel_tol=1e-9), \
        "the signature tally lost a counted call"
    return {"total": total, "matmul": acc["matmul"], "conv": acc["conv"],
            "flags": [], "top_shapes": [(k, float(v)) for k, v in top_shapes]}
