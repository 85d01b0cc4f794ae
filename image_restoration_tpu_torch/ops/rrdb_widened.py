"""Widened (concat-absorbed) RRDB forward.

Port of `image_restoration_tpu/ops/rrdb_widened.py:51-196`. A conv over a
concat is the sum of convs over its parts, so each dense block's 15 weight
slices are regrouped by input instead of by output:

    stage 0: x  → [pre1|pre2|pre3|pre4|pre5]   nf → 4·gc + nf   (64 → 192)
    stage 1: c1 → [q2|q3|q4|q5]                gc → 3·gc + nf   (32 → 160)
    stage 2: c2 → [q3|q4|q5]                   gc → 2·gc + nf   (32 → 128)
    stage 3: c3 → [q4|q5]                      gc → gc + nf     (32 → 96)
    stage 4: c4 → [q5]                         gc → nf          (32 → 64)

    c_k = lrelu(sum of the k-th slices);  x5 = sum of the 5th slices.

The multiply-adds are the same set; the concats disappear. In float32 the
forward equals `RRDBNet.forward` to summation order, in bf16 to rounding.
Optional g-way block-diagonal tile packing composes on top, as in
`packed_inference.py`. The stage convs are PyTorch's `F.conv2d` (the JAX
package leaves them to XLA, `rrdb_widened.py:106-110`); stage weights are
OIHW, stacked over the `num_block` blocks on a leading axis.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .packed_inference import (RDBS, RRDB_HEAD_TAIL, _block_diag, conv_nhwc,
                               pack_batch, rrdb_tail, unpack_batch)
from .rrdb_common import lrelu, mul


def stage_widths(nf: int, gc: int) -> list:
    """Per stage s, the widths of its output slices: c_{s+1} … c4, then x5."""
    return [[gc] * (4 - s) + [nf] for s in range(5)]


def widen_rdb(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
               nf: int, gc: int) -> Dict[str, torch.Tensor]:
    """One dense block's conv1…conv5 (OIHW weights, biases) → stage weights
    w0…w4 (OIHW) and the five biases concatenated, `b`."""
    stages = {}
    for s in range(5):  # s = 0: x; s = 1…4: c_s
        lo = nf + (s - 1) * gc if s > 0 else 0
        hi = lo + (gc if s > 0 else nf)
        # conv_{k+1} reads input part s iff k ≥ s
        stages[f"w{s}"] = torch.cat([ws[k][:, lo:hi] for k in range(s, 5)],
                                    dim=0)
    # the biases are added once, on stage 0's output slices
    stages["b"] = torch.cat(list(bs), dim=0)
    return stages


def rdb_convs(rdb):
    """([conv1…conv5 weights], [their biases]) of a ResidualDenseBlock."""
    convs = [getattr(rdb, f"conv{j}") for j in range(1, 6)]
    return [c.weight for c in convs], [c.bias for c in convs]


@torch.no_grad()
def widen_rrdbnet_params(net, g: int = 1, dtype=torch.bfloat16) -> Dict:
    """An `RRDBNet`'s weights in the widened form, as
    `widen_rrdbnet_params` of the JAX package: head/tail (weight, bias),
    block-diagonal for g > 1; `blocks[rdb][k]` stacked over the blocks; on
    the net's device."""
    nf, gc = net.num_feat, net.num_grow_ch

    def bd(w, b):
        return (_block_diag(w, g), b.repeat(g)) if g > 1 else (w, b)

    out: Dict = {}
    for name in RRDB_HEAD_TAIL:
        conv = getattr(net, name)
        out[name] = bd(conv.weight.detach().to(dtype),
                       conv.bias.detach().to(dtype))
    blocks = {rdb: {} for rdb in RDBS}
    for rdb in RDBS:
        per_block = []
        for blk in net.body:
            ws, bs = rdb_convs(getattr(blk, rdb))
            st = widen_rdb([w.to(dtype) for w in ws],
                            [b.to(dtype) for b in bs], nf, gc)
            if g > 1:
                st = {k: (v.repeat(g) if k == "b" else _block_diag(v, g))
                      for k, v in st.items()}
            per_block.append(st)
        blocks[rdb] = {k: torch.stack([st[k] for st in per_block])
                       for k in per_block[0]}
    out["blocks"] = blocks
    return out


def _slice_g(t: torch.Tensor, widths: Sequence[int], g: int,
             idx: int) -> torch.Tensor:
    """Slice `idx` of a stage output laid out [slices …] once per group."""
    per, lo, w = sum(widths), sum(widths[:idx]), widths[idx]
    if g == 1:
        return t[..., lo:lo + w]
    return torch.cat([t[..., k * per + lo:k * per + lo + w]
                      for k in range(g)], dim=-1)


def _widened_rdb_forward(x, st, nf: int, gc: int, g: int):
    """The re-associated dense block: x (N, H, W, g·nf) → the same shape."""
    widths = stage_widths(nf, gc)
    outs = [conv_nhwc(x, st["w0"], st["b"])]
    for k in range(1, 5):
        # c_k = lrelu(the k-th slice of every stage so far), in stage order
        acc = _slice_g(outs[0], widths[0], g, k - 1)
        for s in range(1, k):
            acc = acc + _slice_g(outs[s], widths[s], g, k - 1 - s)
        outs.append(conv_nhwc(lrelu(acc), st[f"w{k}"]))
    x5 = _slice_g(outs[0], widths[0], g, 4)
    for s in range(1, 5):
        x5 = x5 + _slice_g(outs[s], widths[s], g, 4 - s)
    return mul(x5, 0.2) + x


@torch.no_grad()
def widened_rrdbnet_forward(wp: Dict, x: torch.Tensor, num_block: int,
                            scale: int = 4, g: int = 1, nf: int = 64,
                            gc: int = 32) -> torch.Tensor:
    """The RRDBNet ×4 forward on the widened weights: x (N, H, W, 3), N
    divisible by g → (N, 4H, 4W, 3) in the weights' dtype."""
    if scale != 4:
        raise ValueError("widened RRDBNet implements the ×4 head")
    if x.shape[0] % g:
        raise ValueError(f"batch {x.shape[0]} must divide by the pack "
                         f"factor {g}")
    hp = (pack_batch(x, g) if g > 1 else x).to(wp["conv_first"][0].dtype)
    feat = conv_nhwc(hp, *wp["conv_first"])
    body = feat
    for bi in range(num_block):
        t = body
        for rdb in RDBS:
            st = {k: v[bi] for k, v in wp["blocks"][rdb].items()}
            t = _widened_rdb_forward(t, st, nf, gc, g)
        body = mul(t, 0.2) + body
    out = rrdb_tail(feat, body, wp)
    return unpack_batch(out, g, 3) if g > 1 else out
