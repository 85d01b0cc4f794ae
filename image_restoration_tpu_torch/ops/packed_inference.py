"""Channel-packed inference of SRVGGNetCompact and RRDBNet (bf16 serving).

Port of `image_restoration_tpu/ops/packed_inference.py`. Two tiles ride
one conv on the channel axis with block-diagonal weights:

    conv(x_pair, diag(W, W)) == [conv(x1, W); conv(x2, W)]   (exact)

Half of each packed conv's multiply-adds multiply the structural zeros. The
convs are cuDNN's, in plain PyTorch; this path has no kernel of its own.
Packed weights are OIHW, as the port's convs hold them.

The RRDBNet half (`packed_inference.py:101-196`) packs g tiles, g = 4 by
default; its 23 blocks are a Python loop over weights stacked per conv.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .pixel_ops import pixel_shuffle
from .rrdb_common import lrelu, mul, nearest2x


def _block_diag(w: torch.Tensor, g: int, in_dim: int = 1) -> torch.Tensor:
    """g copies of w on the diagonal of (out, in): dim 0 is the output
    channel, `in_dim` the input channel (1 for OIHW, 3 for (O, 3, 3, I))."""
    o, i = w.shape[0], w.shape[in_dim]
    shape = list(w.shape)
    shape[0], shape[in_dim] = g * o, g * i
    out = w.new_zeros(shape)
    for k in range(g):
        out[k * o:(k + 1) * o].narrow(in_dim, k * i, i).copy_(w)
    return out


def pack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """(N, H, W, C) → (N/g, H, W, g·C): g batch entries on the channel axis."""
    n = x.shape[0]
    return torch.cat([x[i * n // g:(i + 1) * n // g] for i in range(g)],
                     dim=-1)


def unpack_batch(x: torch.Tensor, g: int, c: int) -> torch.Tensor:
    """The inverse of `pack_batch` for c channels per entry."""
    return torch.cat([x[..., i * c:(i + 1) * c] for i in range(g)], dim=0)


@torch.no_grad()
def pack_srvgg_params(net, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Packed weights of an `SRVGGNetCompact` (PReLU): w_i, b_i, a_i for
    body convs 0 … num_conv, then w_last and b_last; on the net's device."""
    packed = {}
    layers = net.conv_layers()
    for i, (w, b, a) in enumerate(layers[:-1]):
        packed[f"w_{i}"] = _block_diag(w.to(dtype), 2)
        packed[f"b_{i}"] = b.to(dtype).repeat(2)
        packed[f"a_{i}"] = a.to(dtype).repeat(2)
    w, b, _ = layers[-1]
    packed["w_last"] = _block_diag(w.to(dtype), 2)
    packed["b_last"] = b.to(dtype).repeat(2)
    return packed


def conv_nhwc(t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None = None) -> torch.Tensor:
    """3×3 SAME conv of NHWC t with OIHW w, then `+ b` as a separate add
    (the JAX forms add the bias after the conv's rounding)."""
    y = F.conv2d(t.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return y if b is None else y + b


@torch.no_grad()
def packed_srvgg_forward(packed: Dict[str, torch.Tensor], x: torch.Tensor,
                         num_conv: int, upscale: int = 4) -> torch.Tensor:
    """x: (N, H, W, 3) with N even → (N, H·r, W·r, 3), the packed weights'
    dtype. Equals `SRVGGNetCompact.forward` up to the dtype's rounding."""
    n = x.shape[0]
    if n % 2:
        raise ValueError(f"packed inference needs an even tile batch, got {n}")
    hp = pack_batch(x, 2).to(packed["w_0"].dtype)
    for i in range(num_conv + 1):
        hp = conv_nhwc(hp, packed[f"w_{i}"], packed[f"b_{i}"])
        hp = torch.where(hp >= 0, hp, hp * packed[f"a_{i}"])
    hp = conv_nhwc(hp, packed["w_last"], packed["b_last"])
    oc = 3 * upscale ** 2
    out = unpack_batch(hp, 2, oc)
    # the nearest-upsampled base, added before the shuffle: channel
    # c·r² + (a, b) lands at subpixel (a, b) of channel c
    out = out + torch.repeat_interleave(x, upscale * upscale,
                                        dim=-1).to(out.dtype)
    return pixel_shuffle(out, upscale)


# ------------------------------------------------------------- RRDBNet

RRDB_HEAD_TAIL = ("conv_first", "conv_body", "conv_up1", "conv_up2",
                  "conv_hr", "conv_last")
RDBS = ("rdb1", "rdb2", "rdb3")


def rrdb_tail(feat: torch.Tensor, body: torch.Tensor,
              p: Dict[str, tuple]) -> torch.Tensor:
    """RRDBNet after its blocks: feat + conv_body(body), two nearest ×2
    upsamples each with a conv and LeakyReLU, conv_hr, conv_last; p maps
    each conv's name to its (weight, bias)."""
    feat = feat + conv_nhwc(body, *p["conv_body"])
    feat = lrelu(conv_nhwc(nearest2x(feat), *p["conv_up1"]))
    feat = lrelu(conv_nhwc(nearest2x(feat), *p["conv_up2"]))
    feat = lrelu(conv_nhwc(feat, *p["conv_hr"]))
    return conv_nhwc(feat, *p["conv_last"])


@torch.no_grad()
def pack_rrdbnet_params(net, g: int = 4,
                        dtype=torch.bfloat16) -> Dict[str, tuple]:
    """g-way block-diagonal weights of an `RRDBNet`, as
    `pack_rrdbnet_params` of the JAX package: (OIHW weight, bias) per
    head/tail conv, and per `blocks.{rdb}.conv{j}` the `num_block` blocks'
    weights and biases stacked on a leading axis; on the net's device."""

    def bd(conv):
        return (_block_diag(conv.weight.to(dtype), g),
                conv.bias.to(dtype).repeat(g))

    packed = {name: bd(getattr(net, name)) for name in RRDB_HEAD_TAIL}
    for rdb in RDBS:
        for j in range(1, 6):
            ws, bs = zip(*(bd(getattr(getattr(blk, rdb), f"conv{j}"))
                           for blk in net.body))
            packed[f"blocks.{rdb}.conv{j}"] = (torch.stack(ws),
                                               torch.stack(bs))
    return packed


@torch.no_grad()
def packed_rrdbnet_forward(packed: Dict[str, tuple], x: torch.Tensor,
                           num_block: int, scale: int = 4,
                           g: int = 4) -> torch.Tensor:
    """The RRDBNet ×4 forward with g tiles on the channel axis: x (N, H, W,
    3), N divisible by g → (N, 4H, 4W, 3) in the packed weights' dtype.
    Equals `RRDBNet.forward` up to the dtype's rounding."""
    if scale != 4:
        raise ValueError("packed RRDBNet implements the ×4 head")
    if x.shape[0] % g:
        raise ValueError(f"batch {x.shape[0]} must divide by the pack "
                         f"factor {g}")
    hp = pack_batch(x, g).to(packed["conv_first"][0].dtype)
    feat = conv_nhwc(hp, *packed["conv_first"])
    nf = feat.shape[-1] // g

    def cat(parts):
        # concatenate per packed group, so the block-diagonal weights line
        # up: [x_0, c1_0, …, x_1, c1_1, …]
        return torch.cat([p[..., k * pc:(k + 1) * pc] for k in range(g)
                          for p, pc in parts], dim=-1)

    body = feat
    for bi in range(num_block):
        t = body
        for rdb in RDBS:
            feats = [(t, nf)]
            for j in range(1, 5):
                w, b = (v[bi] for v in packed[f"blocks.{rdb}.conv{j}"])
                y = lrelu(conv_nhwc(cat(feats) if j > 1 else t, w, b))
                feats.append((y, y.shape[-1] // g))
            w, b = (v[bi] for v in packed[f"blocks.{rdb}.conv5"])
            t = mul(conv_nhwc(cat(feats), w, b), 0.2) + t
        body = mul(t, 0.2) + body
    return unpack_batch(rrdb_tail(feat, body, packed), g, 3)
