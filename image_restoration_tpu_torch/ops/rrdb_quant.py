"""int8 post-training-quantized RRDBNet on the widened dense-block form.

Port of `image_restoration_tpu/ops/rrdb_quant.py:44-202`:

  * weights: symmetric int8, one scale per output channel of each widened
    stage conv;
  * activations: one scale per tensor from calibration, the dense block
    input t and c1…c4, so 5 per dense block, (num_block, 3, 5) in all;
  * folding: a stage's output slice that feeds c_j carries 127/s_{c_j} and
    the x5 slice the 0.2 residual factor, folded into the per-channel
    dequantization vector (LeakyReLU commutes with a positive scale);
  * int32 sums; int8 activations between stages; the dense block's residual
    and the block carry stay bf16. The six head and tail convs stay bf16.

Every stage conv of `quantized_rrdb_forward` is one launch of kernel K2 in
its RRDB stage mode (`ops/int8_conv.py` `int8_conv3x3_rrdb_stage`): the
slice sums, LeakyReLU, requantization, residuals and block carry run in its
epilogue on one running bf16 buffer P of slice sums, allocated once per
forward. So a block is 15 launches and no other kernel, 345 launches for
RRDBNet-23, and the body's only glue is the one quantization of `feat`
before block 0. The arithmetic is the chain's op by op (the op's plain
version is K2's "bf16_deq" epilogue followed by that glue), so the forward
is bit-equal to it. The forward records the spans `rrdb.head`
(conv_first), `rrdb.body` (the blocks) and `rrdb.tail` (conv_body to
conv_last), adds its batch to the counter `rrdb.tiles`, its stage convs to
`rrdb.stages` and those run with the fused epilogue to `rrdb.fused_stages`
(`utils/profiler.py`). The weights are
(Cout, 3, 3, Cin) int8, K2's layout, stacked over the blocks on a leading
axis; head and tail weights are OIHW bf16. The host arithmetic of
`quantize_rrdb_params` is the JAX package's, in numpy, so the quantized
tensors equal its pytree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiler import count, span
from .int8_conv import int8_conv3x3_rrdb_stage
from .packed_inference import RDBS, RRDB_HEAD_TAIL, conv_nhwc, rrdb_tail
from .quantized_inference import bf16_vector, no_tf32
from .rrdb_common import lrelu, mul, to_int8
from .rrdb_widened import rdb_convs, stage_widths, widen_rdb

_GC, _NF = 32, 64
_WIDTHS = stage_widths(_NF, _GC)


@torch.no_grad()
def calibrate_rrdb_act_scales(net, x: torch.Tensor) -> torch.Tensor:
    """(num_block, 3, 5) |activation| maxima — [t, c1, c2, c3, c4] of each
    dense block — of the plain float32 forward of `net` (an RRDBNet) on the
    calibration batch x (N, H, W, 3); on x's device, TF32 off."""

    def conv(t, c):
        return F.conv2d(t.permute(0, 3, 1, 2), c.weight.float(),
                        c.bias.float(), padding=1).permute(0, 2, 3, 1)

    scales = []
    with no_tf32():
        body = conv(x.float(), net.conv_first)
        for blk in net.body:
            t = body
            for rdb in RDBS:
                convs = [getattr(getattr(blk, rdb), f"conv{j}")
                         for j in range(1, 6)]
                feats, row = [t], [t.abs().max()]
                for c in convs[:4]:
                    y = lrelu(conv(torch.cat(feats, -1), c))
                    row.append(y.abs().max())
                    feats.append(y)
                t = mul(conv(torch.cat(feats, -1), convs[4]), 0.2) + t
                scales.append(torch.stack(row))
            body = mul(t, 0.2) + body
    return torch.stack(scales).reshape(len(net.body), 3, 5)


def _quant_stage(w_hwio: np.ndarray, s_in, fold: np.ndarray):
    """int8 per-output-channel weights (Cout, 3, 3, Cin) and the folded
    dequantization vector (float, rounded to bf16 by the caller)."""
    w = np.asarray(w_hwio, np.float32)
    w_scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0 + 1e-12
    w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    deq = (s_in / 127.0) * w_scale * fold
    return np.ascontiguousarray(w_q.transpose(3, 0, 1, 2)), deq


def _fold_vec(s: int, row: np.ndarray) -> np.ndarray:
    """Per-channel fold factors of stage s's output slices: 127/s_c for the
    slices that feed c_{s+1} … c_4, 0.2 for the x5 slice."""
    widths = _WIDTHS[s]
    parts = [np.full(wdt, 127.0 / row[s + 1 + j])
             for j, wdt in enumerate(widths[:-1])]
    parts.append(np.full(widths[-1], 0.2))
    return np.concatenate(parts)


@torch.no_grad()
def quantize_rrdb_params(net, act_scales) -> Dict:
    """The widened, quantized weights of an RRDBNet (num_feat 64,
    num_grow_ch 32) for `quantized_rrdb_forward`, on the net's device:
    head/tail (OIHW bf16 weight, bf16 bias); `blocks[rdb]` with w0…w4
    (int8), deq0…deq4, b (bf16) and rin_t (bf16 127/s_t), stacked over the
    blocks."""
    if (net.num_feat, net.num_grow_ch) != (_NF, _GC):
        raise ValueError(f"the int8 RRDB path takes num_feat {_NF} and "
                         f"num_grow_ch {_GC}, got {net.num_feat} and "
                         f"{net.num_grow_ch}")
    if isinstance(act_scales, torch.Tensor):
        act_scales = act_scales.cpu().numpy()
    act_scales = np.asarray(act_scales, np.float32)
    device = net.conv_first.weight.device
    q: Dict = {}
    for name in RRDB_HEAD_TAIL:
        conv = getattr(net, name)
        q[name] = (conv.weight.to(torch.bfloat16),
                   conv.bias.to(torch.bfloat16))
    q["blocks"] = {}
    for ri, rdb in enumerate(RDBS):
        per_block = []
        for bi, blk in enumerate(net.body):
            row = act_scales[bi, ri]  # [s_t, s_c1 … s_c4]
            ws, bs = rdb_convs(getattr(blk, rdb))
            st = widen_rdb([w.detach().float().cpu() for w in ws],
                            [b.detach().float().cpu() for b in bs], _NF, _GC)
            sd = {}
            for s in range(5):
                w_hwio = st[f"w{s}"].numpy().transpose(2, 3, 1, 0)
                w_q, deq = _quant_stage(w_hwio, row[s], _fold_vec(s, row))
                sd[f"w{s}"] = torch.from_numpy(w_q).to(device)
                sd[f"deq{s}"] = bf16_vector(deq, 1, device)
            # the bias is added once, in stage 0's epilogue: the same fold
            sd["b"] = bf16_vector(st["b"].numpy() * _fold_vec(0, row), 1, device)
            # c1…c4 come out of the fold at their 127/s_c scale already; only
            # the dense block input t needs its factor
            sd["rin_t"] = bf16_vector(127.0 / row[0], 1, device).reshape(())
            per_block.append(sd)
        q["blocks"][rdb] = {k: torch.stack([sd[k] for sd in per_block])
                            for k in per_block[0]}
    return q


def _quant_rdb(x_q: torch.Tensor, t: torch.Tensor, sd: Dict,
               p: torch.Tensor, body: torch.Tensor | None,
               rin_next: torch.Tensor | None):
    """One int8 widened dense block on K2's RRDB stage mode: x_q int8 (N, H,
    W, 64) = t·rin_t, t bf16 (N, H, W, 64), P the running slice sums.
    Returns (the next dense block's int8 input, or None where `rin_next` is
    None; t', or the block carry where `body` is given)."""
    for s in range(4):
        x_q, _ = int8_conv3x3_rrdb_stage(x_q, sd[f"w{s}"], sd[f"deq{s}"],
                                         sd["b"] if s == 0 else None, p,
                                         stage=s)
    return int8_conv3x3_rrdb_stage(x_q, sd["w4"], sd["deq4"], None, p, t,
                                   body, rin_next, stage=4)


@torch.no_grad()
def quantized_rrdb_forward(q: Dict, x: torch.Tensor, num_block: int,
                           scale: int = 4) -> torch.Tensor:
    """x (N, H, W, 3) in [0, 1] → bf16 (N, 4H, 4W, 3); the ×4 head only."""
    if scale != 4:
        raise ValueError("the int8 RRDB path implements the ×4 head")
    count("rrdb.tiles", int(x.shape[0]))
    with span("rrdb.head"):
        feat = conv_nhwc(x.to(torch.bfloat16), *q["conv_first"])
    with span("rrdb.body"):
        dense = [{k: v[bi] for k, v in q["blocks"][rdb].items()}
                 for bi in range(num_block) for rdb in RDBS]
        body = feat.contiguous()
        if dense:
            p = body.new_empty((*body.shape[:3], sum(_WIDTHS[1])))
            x_q, t = to_int8(body, dense[0]["rin_t"]), body
            for i, sd in enumerate(dense):
                carry = i % len(RDBS) == len(RDBS) - 1
                x_q, t = _quant_rdb(
                    x_q, t, sd, p, body if carry else None,
                    dense[i + 1]["rin_t"] if i + 1 < len(dense) else None)
                if carry:
                    body = t
        count("rrdb.stages", 5 * len(dense))
        count("rrdb.fused_stages", 5 * len(dense))
    with span("rrdb.tail"):
        return rrdb_tail(feat, body, q)
