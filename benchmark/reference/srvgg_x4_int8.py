"""Plain PyTorch reference of the ×4 SR tile engine: SRVGGNetCompact
(Real-ESRGAN's `realesr-general-x4v3` architecture) quantized to int8 after
training, served over halo tiles with uint8 in and out.

What the configuration states, worked out from the weights and the
calibration batch alone (nothing here imports the measured program):
  * calibration: a float32 forward (TF32 off) over the calibration batch;
    one scale per conv input, `max|activation|`, and the `max|output|` of
    conv_last;
  * weights: symmetric int8, one scale per output channel,
    `max|w| / 127 + 1e-12`, rounded half to even and clipped to ±127; the
    dequantization `s_in / 127 · w_scale`, bias and PReLU slope in bfloat16,
    with the next layer's `127 / s_out` folded into the dequantization and
    the bias (a positive scale commutes with PReLU);
  * each conv: exact integer sums of int8 × int8 (an im2col matrix times
    the weight in float32: every product and partial sum is an integer
    below 2**24, so the float32 sums are exact), then in bfloat16
    `acc · deq + b`, PReLU, round, clip to ±127; conv_last keeps an int8
    output against its own output scale;
  * the tail: `int8 · s_out / 127` in bfloat16, plus the input repeated
    over the 16 sub-pixels, pixel shuffle, clip to [0, 1], round to uint8;
  * tiling: the photo reflect-padded to a whole grid of `tile` plus a
    `halo` on every side, each tile run alone, the centres stitched.
The input of the chain is the uint8 tile in bfloat16 over 255, quantized
against the first scale. `bits=4` gives the same chain at ±7 (the control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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


def schema(net: dict) -> List[Tuple[str, tuple, float, float]]:
    """[(name, shape, mean, std)]: Real-ESRGAN's `body.*` layout. Body
    convs at He's std for PReLU(0.25), so activations keep their scale over
    33 layers; conv_last a tenth of that, so the ×4 residual is detail on
    top of the upsampled input (the config's `assumed`)."""
    nf, nc, r = net["num_feat"], net["num_conv"], net["upscale"]
    out, cin = [], net.get("num_in_ch", 3)
    for i in range(nc + 1):
        std = math.sqrt(2.0 / (1.0 + 0.25 ** 2) / (cin * 9))
        out.append((f"body.{2 * i}.weight", (nf, cin, 3, 3), 0.0, std))
        out.append((f"body.{2 * i}.bias", (nf,), 0.0, 0.01))
        out.append((f"body.{2 * i + 1}.weight", (nf,), 0.25, 0.02))
        cin = nf
    cout = net.get("num_out_ch", 3) * r * r
    out.append((f"body.{2 * (nc + 1)}.weight", (cout, nf, 3, 3), 0.0,
                0.1 / math.sqrt(nf * 9)))
    out.append((f"body.{2 * (nc + 1)}.bias", (cout,), 0.0, 0.001))
    return out


def _layers(p, net):
    nc = net["num_conv"]
    return ([(p[f"body.{2 * i}.weight"], p[f"body.{2 * i}.bias"],
              p[f"body.{2 * i + 1}.weight"]) for i in range(nc + 1)]
            + [(p[f"body.{2 * (nc + 1)}.weight"],
                p[f"body.{2 * (nc + 1)}.bias"], None)])


@torch.no_grad()
def calibrate(p: Dict[str, torch.Tensor], net: dict,
              calib: torch.Tensor) -> List[float]:
    """The num_conv + 3 activation scales from calib (N, H, W, 3) float
    [0, 1], on calib's device."""
    scales = []
    h = calib.float()
    with full_fp32():
        for w, b, a in _layers(p, net):
            scales.append(h.abs().max())
            h = F.conv2d(h.permute(0, 3, 1, 2), w.float(),
                         padding=1).permute(0, 2, 3, 1) + b.float()
            if a is not None:
                h = torch.where(h >= 0, h, h * a.float())
    scales.append(h.abs().max())
    return torch.stack(scales).tolist()


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(device)


def _fold(t: torch.Tensor, r: float) -> torch.Tensor:
    return (t.float() * torch.tensor(r, dtype=torch.float32)).to(
        torch.bfloat16)


@torch.no_grad()
def quantize(p: Dict[str, torch.Tensor], net: dict, scales: List[float],
             bits: int = 8) -> dict:
    """Integer weights (as float32, OIHW) and bfloat16 epilogue vectors of
    every conv, on the parameters' device."""
    qmax = float(2 ** (bits - 1) - 1)
    layers = _layers(p, net)
    device = layers[0][0].device
    q = []
    for i, (w, b, a) in enumerate(layers):
        wn = w.detach().float().cpu().numpy()
        w_scale = (np.abs(wn).max(axis=(1, 2, 3)) / np.float32(qmax)
                   + np.float32(1e-12))
        w_q = np.clip(np.round(wn / w_scale[:, None, None, None]),
                      -qmax, qmax)
        deq = _bf16(np.float32(scales[i] / qmax) * w_scale, device)
        bias = _bf16(b.detach().float().cpu().numpy(), device)
        s_out = scales[i + 1] + (1e-12 if a is None else 0.0)
        r = qmax / s_out
        q.append(dict(w=torch.from_numpy(w_q.astype(np.float32)).to(device),
                      deq=_fold(deq, r), b=_fold(bias, r),
                      a=None if a is None else a.to(torch.bfloat16)))
    return dict(layers=q, qmax=qmax,
                s_in=torch.tensor(scales[0], dtype=torch.float32,
                                  device=device),
                inv_last=torch.tensor((scales[-1] + 1e-12) / qmax,
                                      dtype=torch.bfloat16, device=device),
                upscale=net["upscale"])


def int_conv3x3(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer sums of the SAME 3×3 conv of NHWC integers xq (as
    float32) with the OIHW integer weight w: (N, H, W, Cout) float32."""
    n, h, wd, c = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3)
                      for dx in range(3)], dim=-1)
    wm = w.permute(0, 2, 3, 1).reshape(w.shape[0], 9 * c)
    with full_fp32():
        acc = cols.reshape(-1, 9 * c) @ wm.t()
    return acc.reshape(n, h, wd, w.shape[0])


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC (N, H, W, C·r²) → (N, H·r, W·r, C); channel c·r² + i·r + j is
    sub-pixel (i, j) of output channel c, as `torch.pixel_shuffle`."""
    n, h, w, c = x.shape
    y = F.pixel_shuffle(x.permute(0, 3, 1, 2), r)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def tiles_u8(q: dict, tiles: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) uint8 tiles → (N, S·r, S·r, 3) uint8, one at a time."""
    outs = []
    qmax, r = q["qmax"], q["upscale"]
    for t in tiles.split(1):
        xb = t.to(torch.bfloat16) / 255.0
        ratio = torch.full_like(q["s_in"], qmax) / q["s_in"]
        h = torch.clamp(torch.round(xb.float() * ratio), -qmax, qmax)
        for layer in q["layers"]:
            acc = int_conv3x3(h, layer["w"])
            v = acc.bfloat16() * layer["deq"] + layer["b"]
            if layer["a"] is not None:
                v = torch.where(v >= 0, v, v * layer["a"])
            h = torch.clamp(torch.round(v), -qmax, qmax).float()
        y = h.to(torch.bfloat16) * q["inv_last"]
        y = y + torch.repeat_interleave(xb, r * r, dim=-1)
        y = pixel_shuffle(y, r)
        outs.append(torch.round(torch.clamp(y.float(), 0.0, 1.0) * 255.0)
                    .to(torch.uint8))
    return torch.cat(outs, 0)


def _reflect(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), (before, after),
                                   mode="reflect")).to(device)


@torch.no_grad()
def restore_u8(q: dict, img: torch.Tensor, tile: int,
               halo: int) -> torch.Tensor:
    """(H, W, 3) RGB uint8 → (H·r, W·r, 3) RGB uint8 over halo tiles."""
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
