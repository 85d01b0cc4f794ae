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

Every stage conv of `quantized_rrdb_forward` is one launch of kernel K2
(`ops/int8_conv.py`, "bf16_deq" epilogue): 15 per RRDB block, 345 for
RRDBNet-23. The weights are (Cout, 3, 3, Cin) int8, K2's layout, stacked over
the blocks on a leading axis; head and tail weights are OIHW bf16. The host
arithmetic of `quantize_rrdb_params` is the JAX package's, in numpy, so the
quantized tensors equal its pytree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .int8_conv import int8_conv3x3_requant
from .packed_inference import RDBS, RRDB_HEAD_TAIL, conv_nhwc, rrdb_tail
from .quantized_inference import bf16_vector, no_tf32
from .rrdb_common import lrelu, mul
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


def _to_int8(t: torch.Tensor, r: torch.Tensor | None = None) -> torch.Tensor:
    """clip(round(t · r), ±127) as int8, t·r rounded to bf16 first; r None
    is the chain's factor 1."""
    t = t.to(torch.bfloat16)
    if r is not None:
        t = t * r
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def _sl(t: torch.Tensor, widths, idx: int) -> torch.Tensor:
    lo = sum(widths[:idx])
    return t[..., lo:lo + widths[idx]]


def _stage(t_q: torch.Tensor, sd: Dict, s: int) -> torch.Tensor:
    """Stage s's int8 conv on K2: int8 in, bf16 acc·deq (+ b at stage 0)
    out."""
    return int8_conv3x3_requant(t_q, sd[f"w{s}"], sd[f"deq{s}"],
                                sd["b"] if s == 0 else None,
                                epilogue="bf16_deq")


def _quant_rdb(t: torch.Tensor, sd: Dict) -> torch.Tensor:
    """t bf16 (N, H, W, 64) → the same; the int8 widened dense block, with
    the JAX chain's order of the bf16 slice sums."""
    outs = [_stage(_to_int8(t, sd["rin_t"]), sd, 0)]
    for k in range(1, 5):
        acc = _sl(outs[0], _WIDTHS[0], k - 1)
        for s in range(1, k):
            acc = acc + _sl(outs[s], _WIDTHS[s], k - 1 - s)
        outs.append(_stage(_to_int8(lrelu(acc)), sd, k))
    x5 = _sl(outs[0], _WIDTHS[0], 4)
    for s in range(1, 5):
        x5 = x5 + _sl(outs[s], _WIDTHS[s], 4 - s)
    return x5 + t  # the x5 slices carry the 0.2 fold


@torch.no_grad()
def quantized_rrdb_forward(q: Dict, x: torch.Tensor, num_block: int,
                           scale: int = 4) -> torch.Tensor:
    """x (N, H, W, 3) in [0, 1] → bf16 (N, 4H, 4W, 3); the ×4 head only."""
    if scale != 4:
        raise ValueError("the int8 RRDB path implements the ×4 head")
    x = x.to(torch.bfloat16)
    feat = conv_nhwc(x, *q["conv_first"])
    body = feat
    for bi in range(num_block):
        t = body
        for rdb in RDBS:
            t = _quant_rdb(t, {k: v[bi] for k, v in q["blocks"][rdb].items()})
        body = mul(t, 0.2) + body
    return rrdb_tail(feat, body, q)
