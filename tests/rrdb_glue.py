"""The int8 RRDB chain's dense block as separate ops: each stage conv on
K2's "bf16_deq" epilogue, then the bf16 slice sums, LeakyReLU,
requantization, residuals and block carry as PyTorch element-wise ops, in
the JAX chain's order (`image_restoration_tpu/ops/rrdb_quant.py`).

`ops/rrdb_quant.py` folds that glue into K2's epilogue
(`int8_conv3x3_rrdb_stage`); the tests hold it against this form, which
imports neither jax nor the JAX package, so card-only tests use it too.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from image_restoration_tpu_torch.ops.int8_conv import (
    int8_conv3x3_requant, int8_conv3x3_requant_plain)
from image_restoration_tpu_torch.ops.packed_inference import (RDBS,
                                                              conv_nhwc,
                                                              rrdb_tail)
from image_restoration_tpu_torch.ops.rrdb_common import lrelu, mul, to_int8
from image_restoration_tpu_torch.ops.rrdb_widened import stage_widths

WIDTHS = stage_widths(64, 32)


def sl(t: torch.Tensor, widths, idx: int) -> torch.Tensor:
    """Slice `idx` of a stage output whose slices have `widths`."""
    lo = sum(widths[:idx])
    return t[..., lo:lo + widths[idx]]


def slice_sum(outs, k: int) -> torch.Tensor:
    """The chain's sum of the k-th slices (k = 1…4: c_k's pre-activation,
    5: x5) over the stage outputs `outs` so far, left to right."""
    acc = sl(outs[0], WIDTHS[0], k - 1)
    for s in range(1, min(k, len(outs))):
        acc = acc + sl(outs[s], WIDTHS[s], k - 1 - s)
    return acc


def glue_rdb(t: torch.Tensor, sd: Dict, conv=int8_conv3x3_requant):
    """One dense block: t bf16 (N, H, W, 64) → the same, and the int8 input
    of each of its five stage convs."""
    ins = [to_int8(t, sd["rin_t"])]
    outs = [conv(ins[0], sd["w0"], sd["deq0"], sd["b"], epilogue="bf16_deq")]
    for k in range(1, 5):
        ins.append(to_int8(lrelu(slice_sum(outs, k))))
        outs.append(conv(ins[k], sd[f"w{k}"], sd[f"deq{k}"], None,
                         epilogue="bf16_deq"))
    return slice_sum(outs, 5) + t, ins  # the x5 slices carry the 0.2 fold


@torch.no_grad()
def glue_forward(q: Dict, x: torch.Tensor, num_block: int,
                 conv=int8_conv3x3_requant):
    """The int8 RRDBNet ×4 forward with the glue as separate ops: (bf16
    (N, 4H, 4W, 3), the int8 input of every stage conv in order)."""
    feat = conv_nhwc(x.to(torch.bfloat16), *q["conv_first"])
    body, seen = feat, []
    for bi in range(num_block):
        t = body
        for rdb in RDBS:
            t, ins = glue_rdb(t, {k: v[bi] for k, v in
                                  q["blocks"][rdb].items()}, conv)
            seen += ins
        body = mul(t, 0.2) + body
    return rrdb_tail(feat, body, q), seen


# the RRDB stage op's variants: (last stage run, the block carry, the next
# dense block's input)
VARIANTS = {"stage0": (0, False, True), "stage1": (1, False, True),
            "stage2": (2, False, True), "stage3": (3, False, True),
            "stage4": (4, False, True), "carry": (4, True, True),
            "last": (4, True, False)}


def dense_case(n: int, h: int, w: int, seed: int, device) -> Dict:
    """One dense block's operands at random: each stage's own int8 input
    and weights, deq, stage 0's bias, t, body, rin and a P of garbage
    (stage 0 overwrites it all). In a corner of 4 × 5 pixels the inputs are
    127, and every 29th output channel's weights too: the sums there pass
    2^22, which sends the kernel's threads to its scalar epilogue."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device, torch.bfloat16)

    case = {"x": [], "w": [], "deq": []}
    for s, widths in enumerate(WIDTHS):
        cin, cout = (64 if s == 0 else 32), sum(widths)
        x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
        wt = rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8)
        x[:, :4, :5] = 127
        wt[::29] = 127
        # |acc·deq| reaches ~100 (~5,000 at the corner): LeakyReLU's
        # negative side, the int8 clip and bf16's rounding all come up
        scale = 100.0 / (np.sqrt(9 * cin) * 127 ** 2 / 3)
        case["x"].append(torch.from_numpy(x).to(device))
        case["w"].append(torch.from_numpy(wt).to(device))
        case["deq"].append(bf(rng.random(cout) * scale))
    case["b"] = bf(rng.standard_normal(sum(WIDTHS[0])) * 5)
    case["t"] = bf(rng.standard_normal((n, h, w, 64)) * 50)
    case["body"] = bf(rng.standard_normal((n, h, w, 64)) * 50)
    case["rin"] = bf(127.0 / 60.0).reshape(())
    case["p"] = bf(rng.standard_normal((n, h, w, sum(WIDTHS[1]))) * 1e3)
    return case


def run_stages(op, case: Dict, variant: str):
    """The stage op `op` over stages 0 … the variant's last, each on the
    case's own input, P updated in place: (the last stage's outputs, P)."""
    last, carry, more = VARIANTS[variant]
    p = case["p"].clone()
    for s in range(last + 1):
        extra = {}
        if s == 4:
            extra = dict(t=case["t"], body=case["body"] if carry else None,
                         rin=case["rin"] if more else None)
        q, y = op(case["x"][s], case["w"][s], case["deq"][s],
                  case["b"] if s == 0 else None, p, stage=s, **extra)
    return [o for o in (y, q) if o is not None], p


def glue_stages(case: Dict, variant: str, conv=int8_conv3x3_requant_plain):
    """What `run_stages` gives, from the stage convs' "bf16_deq" outputs and
    the chain's glue op by op."""
    last, carry, more = VARIANTS[variant]
    outs = [conv(case["x"][s], case["w"][s], case["deq"][s],
                 case["b"] if s == 0 else None, epilogue="bf16_deq")
            for s in range(last + 1)]
    # P's slice j (c2, c3, c4, x5) was last summed at stage min(last, j - 2)
    p = torch.cat([slice_sum(outs[:min(last, j - 2) + 1], j)
                   for j in range(2, 6)], -1)
    if last < 4:
        return [to_int8(lrelu(slice_sum(outs, last + 1)))], p
    y = slice_sum(outs, 5) + case["t"]
    if carry:
        y = mul(y, 0.2) + case["body"]
    return ([y, to_int8(y, case["rin"])] if more else [y]), p
