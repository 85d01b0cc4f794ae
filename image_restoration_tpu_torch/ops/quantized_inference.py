"""int8 post-training-quantized SRVGGNetCompact (the int8 serving path).

Port of `image_restoration_tpu/ops/quantized_inference.py:31-171`, composed
with the block-diagonal packing of `packed_inference.py`:

  * weights: symmetric int8, one scale per output channel;
  * activations: one symmetric scale per layer, from a calibration batch;
  * int32 accumulation with the requantization fused into the PReLU
    epilogue, whose constants carry the folded 127/s_out;
  * conv_last with an int8 sink: its output requantized to int8 against the
    calibrated |conv_last output| maximum, dequantized by `inv_last` in the
    bf16 tail.

Every int8 conv of `quantized_srvgg_forward` is one launch of kernel K2
(`ops/int8_conv.py`, bf16 epilogue): body convs with PReLU, conv_last with
alpha = 1. The quantized weights are (Cout, 3, 3, Cin) int8, K2's layout; the
epilogue vectors are bfloat16, as in the JAX pytree.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .int8_conv import int8_conv3x3_requant
from .packed_inference import _block_diag, pack_batch, unpack_batch
from .pixel_ops import pixel_shuffle


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@torch.no_grad()
def calibrate_srvgg_act_scales(net, x: torch.Tensor) -> torch.Tensor:
    """|activation| maxima of a float32 forward of `net` (an
    SRVGGNetCompact with PReLU) on the calibration batch x (N, H, W, 3):
    one per conv input (num_conv + 2 of them), then the |conv_last output|
    maximum that the int8 sink needs. float32 (TF32 off) on x's device."""
    scales = []
    h = x.float()
    with no_tf32():
        for w, b, a in net.conv_layers():
            scales.append(h.abs().max())
            h = F.conv2d(h.permute(0, 3, 1, 2), w.float(),
                         padding=1).permute(0, 2, 3, 1) + b.float()
            if a is not None:
                h = torch.where(h >= 0, h, h * a.float())
    scales.append(h.abs().max())
    return torch.stack(scales)


def bf16_vector(a: np.ndarray, pack: int, device) -> torch.Tensor:
    """float32 numpy → bfloat16 (round to nearest even), tiled `pack` times."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).repeat(pack).to(device)


def _times(t: torch.Tensor, r: float) -> torch.Tensor:
    """bf16 · r in float32 (r rounded to float32 first), back to bf16."""
    return (t.float() * torch.tensor(r, dtype=torch.float32)).to(
        torch.bfloat16)


@torch.no_grad()
def quantize_srvgg_params(net, act_scales: Sequence[float],
                          pack: int = 2) -> Dict[str, torch.Tensor]:
    """int8 weights (per output channel) and bf16 requantization vectors of
    `net`, packed `pack`-way block-diagonally; on the net's device.

    The host arithmetic is the JAX package's, in numpy float32, so the
    pytree equals its `quantize_srvgg_params` key by key."""
    num_conv = net.num_conv
    scales = [float(s) for s in act_scales]
    layers = net.conv_layers()
    device = layers[0][0].device
    q: Dict[str, torch.Tensor] = {}

    def quant_layer(weight, bias, s_in, name):
        w = weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
        w_scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0 + 1e-12
        w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
        w_q = torch.from_numpy(w_q.transpose(3, 0, 1, 2).copy())  # O,3,3,I
        q[f"w_{name}"] = _block_diag(w_q, pack, in_dim=3).to(device)
        q[f"deq_{name}"] = bf16_vector((s_in / 127.0) * w_scale, pack, device)
        q[f"b_{name}"] = bf16_vector(bias.detach().float().cpu().numpy(), pack,
                               device)

    for i, (w, b, a) in enumerate(layers[:-1]):
        if a is None:
            raise ValueError("the int8 path needs act_type='prelu'")
        quant_layer(w, b, scales[i], str(i))
        q[f"a_{i}"] = bf16_vector(a.detach().float().cpu().numpy(), pack, device)
        # fold 127/s_out into deq and b: PReLU commutes with a positive scale
        r = 127.0 / scales[i + 1]
        q[f"deq_{i}"] = _times(q[f"deq_{i}"], r)
        q[f"b_{i}"] = _times(q[f"b_{i}"], r)
    w, b, _ = layers[-1]
    quant_layer(w, b, scales[num_conv + 1], "last")
    if len(scales) > num_conv + 2:
        s_out = scales[num_conv + 2] + 1e-12
        r = 127.0 / s_out
        q["deq_last"] = _times(q["deq_last"], r)
        q["b_last"] = _times(q["b_last"], r)
        q["inv_last"] = torch.tensor(s_out / 127.0, dtype=torch.bfloat16,
                                     device=device)
    q["s_in_0"] = torch.tensor(scales[0], dtype=torch.float32, device=device)
    return q


@torch.no_grad()
def quantized_srvgg_forward(q: Dict[str, torch.Tensor], x: torch.Tensor,
                            num_conv: int, upscale: int = 4, pack: int = 2,
                            crop_halo: int = 0) -> torch.Tensor:
    """x: (N, H, W, 3) in [0, 1], N divisible by `pack` → bf16
    (N, H·r, W·r, 3).

    crop_halo > 1: x carries a tile halo of that width whose output the
    tiler drops; the int8 activations are cropped to halo − 1 before
    conv_last (one pixel of context keeps the interior exact under SAME
    padding) and the last ring after it, so conv_last and the tail run at
    the tile size: output (N, (H − 2·crop_halo)·r, (W − 2·crop_halo)·r, 3).
    """
    if "inv_last" not in q:
        raise NotImplementedError(
            "quantized_srvgg_forward needs the int8 sink of conv_last "
            "(act_scales with the |conv_last output| maximum)")
    hp = pack_batch(x, pack)
    # a true float32 division (127.0 / tensor would take the reciprocal)
    ratio = torch.full_like(q["s_in_0"], 127.0) / q["s_in_0"]
    hq = torch.clamp(torch.round(hp.float() * ratio), -127,
                     127).to(torch.int8)
    for i in range(num_conv + 1):
        hq = int8_conv3x3_requant(hq, q[f"w_{i}"], q[f"deq_{i}"],
                                  q[f"b_{i}"], q[f"a_{i}"], epilogue="bf16")
    if crop_halo > 1:
        k = crop_halo - 1
        hq = hq[:, k:-k, k:-k, :].contiguous()
        x = x[:, crop_halo:-crop_halo, crop_halo:-crop_halo, :]
    out = int8_conv3x3_requant(hq, q["w_last"], q["deq_last"], q["b_last"],
                               None, epilogue="bf16")
    if crop_halo > 1:
        out = out[:, 1:-1, 1:-1, :]
    out = unpack_batch(out, pack, 3 * upscale ** 2)
    out = out.to(torch.bfloat16) * q["inv_last"]
    out = out + torch.repeat_interleave(x, upscale * upscale,
                                        dim=-1).to(torch.bfloat16)
    return pixel_shuffle(out, upscale)
