"""Plain PyTorch reference of the int8 ×4 RRDBNet tile engine:
RealESRGAN_x4plus (ESRGAN's RRDBNet, arXiv:1809.00219, with Real-ESRGAN's
x4plus widths) quantized to int8 after training, served over halo tiles with
uint8 in and out.

Written from the published network, in its own dense-block layout:
conv_k of every dense block reads concat(t, c1 … c_{k−1}). Nothing here
imports the measured program. What the configuration states, worked out
from the weights and the calibration batch alone:
  * calibration: the plain float32 forward (TF32 off) over the calibration
    batch; one scale per tensor, `max|activation|`, of the input t of every
    dense block and of its c1 … c4;
  * weights: conv_k's weight is cut by input piece (t, c1, …); each
    (conv_k, piece) block is symmetric int8 with one scale per output
    channel, `max|w| / 127 + 1e-12`, rounded half to even and clipped to
    ±127. The piece's dequantization is `s_piece / 127 · w_scale`, times
    127 / s_{c_k} for conv1 … conv4 (their output is c_k's int8 input of
    the next convs) and times the residual's 0.2 for conv5; conv_k's bias
    takes the same factor and is added to the t piece;
  * each conv_k: exact integer sums per piece (an im2col matrix times the
    weight block in float32: every product and partial sum is an integer
    below 9 · 64 · 127² < 2**24, so the float32 sums are exact), each piece
    in bfloat16 `acc · deq (+ b)`, the pieces summed in bfloat16 in order;
    conv1 … conv4 then LeakyReLU(0.2), round and clip to ±127 (c_k's int8
    values); conv5's sum plus t is the dense block's output;
  * bfloat16 between the convs: the dense blocks' and the RRDB blocks'
    residuals, t's requantization `round(t · 127 / s_t)`, and the head and
    tail convs (conv_first; conv_body, the two nearest ×2 upsamples with
    their convs, conv_hr, conv_last) as float32 sums of bfloat16 values
    rounded to bfloat16, their biases added after;
  * the input: the uint8 tile in bfloat16 over 255; the output clipped to
    [0, 1] and rounded to uint8;
  * tiling: the photo reflect-padded to a whole grid of `tile` plus a
    `halo` on every side, each tile run alone, the centres stitched.
Departures from the published float network, each the engine's: the int8
weights and activations above; bfloat16 everywhere else; every constant of
the chain (0.2, the 127/s factors) rounded to bfloat16 before it
multiplies a bfloat16 tensor. `bits=4` gives the same chain at ±7 (the
control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RDBS = ("rdb1", "rdb2", "rdb3")
TAIL = ("conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last")
# under BasicSR's init each RRDB block is ≈ 1.2× its input (its dense
# blocks are near the identity, its residual 0.2), so the trunk grows ≈
# 1.2**num_block (≈ 66× at 23 blocks); conv_last is drawn at LAST_STD of
# He's std over that growth, about a mid-grey bias, so the ×4 output lies
# inside [0, 1] at any depth (the config's `assumed`)
LAST_STD = 0.08
LAST_BIAS = 0.5


@contextlib.contextmanager
def full_fp32():
    """float32 convs and matmuls without TF32, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _he(cin: int) -> float:
    return math.sqrt(2.0 / (9 * cin))


def _dense_widths(net: dict) -> List[Tuple[int, int]]:
    """(Cin, Cout) of conv1 … conv5 of a dense block."""
    nf, gc = net["num_feat"], net["num_grow_ch"]
    return [(nf + k * gc, gc if k < 4 else nf) for k in range(5)]


def schema(net: dict) -> List[Tuple[str, tuple, float, float]]:
    """[(name, shape, mean, std)] under RRDBNet's checkpoint names:
    BasicSR's init (Kaiming normal, the dense blocks' convs a tenth of it,
    `default_init_weights(..., 0.1)`), biases N(0, 0.01); conv_last
    `LAST_STD` of Kaiming over the trunk's growth, about a mid-grey bias
    (the config's `assumed`)."""
    nf = net["num_feat"]
    out = [("conv_first.weight", (nf, 3, 3, 3), 0.0, _he(3)),
           ("conv_first.bias", (nf,), 0.0, 0.01)]
    for i in range(net["num_block"]):
        for rdb in RDBS:
            for k, (cin, cout) in enumerate(_dense_widths(net), 1):
                name = f"body.{i}.{rdb}.conv{k}"
                out.append((f"{name}.weight", (cout, cin, 3, 3), 0.0,
                            0.1 * _he(cin)))
                out.append((f"{name}.bias", (cout,), 0.0, 0.01))
    for name in TAIL[:-1]:
        out.append((f"{name}.weight", (nf, nf, 3, 3), 0.0, _he(nf)))
        out.append((f"{name}.bias", (nf,), 0.0, 0.01))
    out.append(("conv_last.weight", (3, nf, 3, 3), 0.0,
                LAST_STD * _he(nf) / 1.2 ** net["num_block"]))
    out.append(("conv_last.bias", (3,), LAST_BIAS, 0.01))
    return out


# ------------------------------------------------------------ float32


def _conv(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """3×3 SAME conv of NHWC x with OIHW w (bias inside the conv)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, b,
                    padding=1).permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the slope rounded to x's dtype first."""
    return torch.where(x >= 0, x, x * torch.tensor(0.2, dtype=x.dtype))


def _times(x: torch.Tensor, s: float) -> torch.Tensor:
    return x * torch.tensor(s, dtype=x.dtype)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of NHWC x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _float_forward(p, net, x, seen=None):
    """The float32 RRDBNet ×4 on NHWC x; `seen` collects [t, c1 … c4]
    of every dense block."""
    def conv(t, name):
        return _conv(t, p[f"{name}.weight"].float(), p[f"{name}.bias"].float())

    feat = conv(x.float(), "conv_first")
    body = feat
    for i in range(net["num_block"]):
        t = body
        for rdb in RDBS:
            feats = [t]
            for k in range(1, 5):
                feats.append(_lrelu(conv(torch.cat(feats, -1),
                                         f"body.{i}.{rdb}.conv{k}")))
            if seen is not None:
                seen.append(feats)
            t = _times(conv(torch.cat(feats, -1), f"body.{i}.{rdb}.conv5"),
                       0.2) + t
        body = _times(t, 0.2) + body
    feat = feat + conv(body, "conv_body")
    feat = _lrelu(conv(_up(feat), "conv_up1"))
    feat = _lrelu(conv(_up(feat), "conv_up2"))
    return conv(_lrelu(conv(feat, "conv_hr")), "conv_last")


@torch.no_grad()
def forward(p: Dict[str, torch.Tensor], net: dict,
            x: torch.Tensor) -> torch.Tensor:
    """The plain float32 network: (N, H, W, 3) → (N, 4H, 4W, 3), TF32
    off."""
    with full_fp32():
        return _float_forward(p, net, x)


@torch.no_grad()
def calibrate(p: Dict[str, torch.Tensor], net: dict,
              calib: torch.Tensor) -> np.ndarray:
    """(num_block, 3, 5) float32 maxima |t|, |c1| … |c4| of every dense
    block of the float forward over calib (N, H, W, 3) float [0, 1]."""
    seen: list = []
    with full_fp32():
        _float_forward(p, net, calib, seen)
    rows = [torch.stack([f.abs().max() for f in feats]) for feats in seen]
    return torch.stack(rows).reshape(net["num_block"], 3, 5).cpu().numpy()


# ------------------------------------------------------------ int8


def _bf16(a, device) -> torch.Tensor:
    """numpy float → float32 → bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(device)


def _pieces(net: dict, k: int) -> List[Tuple[int, int]]:
    """[lo, hi) input channels of each piece conv_k (k = 1 … 5) reads: t,
    then c1 … c_{k−1}."""
    nf, gc = net["num_feat"], net["num_grow_ch"]
    return [(0, nf)] + [(nf + j * gc, nf + (j + 1) * gc)
                        for j in range(k - 1)]


@torch.no_grad()
def quantize(p: Dict[str, torch.Tensor], net: dict, scales,
             bits: int = 8) -> dict:
    """Per dense block: `rin_t` (bfloat16 qmax / s_t) and, per conv_k, per
    input piece, the integer weight block as a float32 (9·Cin, Cout) matrix
    in im2col order and its bfloat16 `deq` (and `b` on the t piece); the
    head and tail in bfloat16; on the parameters' device."""
    qmax = float(2 ** (bits - 1) - 1)
    scales = np.asarray(scales, np.float32)
    device = p["conv_first.weight"].device
    q: dict = {"qmax": qmax, "num_block": net["num_block"],
               "upscale": net["upscale"],
               "head_tail": {n: (p[f"{n}.weight"].to(torch.bfloat16),
                                 p[f"{n}.bias"].to(torch.bfloat16))
                             for n in ("conv_first",) + TAIL}}
    blocks = []
    for i in range(net["num_block"]):
        for r, rdb in enumerate(RDBS):
            row = scales[i, r]  # s_t, s_c1 … s_c4
            convs = []
            for k in range(1, 6):
                name = f"body.{i}.{rdb}.conv{k}"
                w = p[f"{name}.weight"].detach().float().cpu().numpy()
                b = p[f"{name}.bias"].detach().float().cpu().numpy()
                cout = w.shape[0]
                # c_k leaves at its own int8 scale; x5 carries the 0.2
                fold = np.full(cout, qmax / row[k] if k < 5 else 0.2)
                fold = fold.astype(np.float64)
                parts = []
                for s, (lo, hi) in enumerate(_pieces(net, k)):
                    wp = w[:, lo:hi]
                    w_scale = (np.abs(wp).max(axis=(1, 2, 3)) / qmax
                               + 1e-12)
                    wq = np.clip(np.round(wp / w_scale[:, None, None, None]),
                                 -qmax, qmax)
                    deq = (row[s] / qmax) * w_scale * fold
                    # rows in im2col order: tap (dy, dx), then channel
                    mat = wq.transpose(2, 3, 1, 0).reshape(-1, cout)
                    parts.append(dict(
                        w=torch.from_numpy(np.ascontiguousarray(
                            mat, np.float32)).to(device),
                        deq=_bf16(deq, device),
                        b=_bf16(b * fold, device) if s == 0 else None))
                convs.append(parts)
            blocks.append(dict(rin_t=_bf16(np.float32(qmax / row[0]),
                                           device), convs=convs))
    q["blocks"] = blocks
    return q


def _im2col(h: torch.Tensor) -> torch.Tensor:
    """(1, H, W, C) → (H·W, 9·C), SAME zero border, tap-major rows."""
    _, hh, ww, c = h.shape
    xp = F.pad(h, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + hh, dx:dx + ww] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(hh * ww, 9 * c)


def _int8(v: torch.Tensor, qmax: float) -> torch.Tensor:
    """round, clip to ±qmax: the integer values, as float32."""
    return torch.clamp(torch.round(v), -qmax, qmax).float()


def _dense_block(t: torch.Tensor, blk: dict, qmax: float) -> torch.Tensor:
    """t bfloat16 (1, H, W, nf) → the int8 dense block's output."""
    shape = t.shape[:3]
    cols = [_im2col(_int8(t * blk["rin_t"], qmax))]
    for k, parts in enumerate(blk["convs"], 1):
        y = None
        with full_fp32():
            for s, part in enumerate(parts):
                acc = cols[s] @ part["w"]
                v = acc.to(torch.bfloat16) * part["deq"]
                if part["b"] is not None:
                    v = v + part["b"]
                y = v if y is None else y + v
        y = y.reshape(*shape, -1)
        if k == 5:
            return y + t
        cols.append(_im2col(_int8(_lrelu(y), qmax)))


def _conv_bf16(x: torch.Tensor, wb) -> torch.Tensor:
    """A head or tail conv: float32 sums of the bfloat16 values, rounded
    to bfloat16, then the bfloat16 bias."""
    w, b = wb
    with full_fp32():
        y = _conv(x.float(), w.float())
    return y.to(torch.bfloat16) + b


@torch.no_grad()
def tiles_u8(q: dict, tiles: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) uint8 tiles → (N, 4S, 4S, 3) uint8, one at a time."""
    ht, qmax, nb = q["head_tail"], q["qmax"], q["num_block"]
    outs = []
    for tile in tiles.split(1):
        feat = _conv_bf16(tile.to(torch.bfloat16) / 255.0, ht["conv_first"])
        body = feat
        for i in range(nb):
            t = body
            for blk in q["blocks"][3 * i:3 * i + 3]:
                t = _dense_block(t, blk, qmax)
            body = _times(t, 0.2) + body
        feat = feat + _conv_bf16(body, ht["conv_body"])
        feat = _lrelu(_conv_bf16(_up(feat), ht["conv_up1"]))
        feat = _lrelu(_conv_bf16(_up(feat), ht["conv_up2"]))
        y = _conv_bf16(_lrelu(_conv_bf16(feat, ht["conv_hr"])),
                       ht["conv_last"])
        outs.append(torch.round(torch.clamp(y.float(), 0.0, 1.0) * 255.0)
                    .to(torch.uint8))
    return torch.cat(outs, 0)


def _reflect(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), (before, after),
                                   mode="reflect")).to(device)


@torch.no_grad()
def restore_u8(q: dict, img: torch.Tensor, tile: int,
               halo: int) -> torch.Tensor:
    """(H, W, 3) RGB uint8 → (4H, 4W, 3) RGB uint8 over halo tiles."""
    h, w, _ = img.shape
    r = q["upscale"]
    gh, gw = math.ceil(h / tile), math.ceil(w / tile)
    pad = img.index_select(0, _reflect(h, halo, halo + gh * tile - h,
                                       img.device))
    pad = pad.index_select(1, _reflect(w, halo, halo + gw * tile - w,
                                       img.device))
    size, t, c = tile + 2 * halo, tile * r, halo * r
    out = torch.empty((gh * t, gw * t, 3), dtype=torch.uint8,
                      device=img.device)
    for i in range(gh):
        for j in range(gw):
            y = tiles_u8(q, pad[None, i * tile:i * tile + size,
                                j * tile:j * tile + size])[0]
            out[i * t:(i + 1) * t, j * t:(j + 1) * t] = y[c:c + t, c:c + t]
    return out[:h * r, :w * r]
