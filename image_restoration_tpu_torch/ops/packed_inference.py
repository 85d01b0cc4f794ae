"""Channel-packed SRVGGNetCompact inference (the packed bf16 serving path).

Port of `image_restoration_tpu/ops/packed_inference.py:26-95`. Two tiles ride
one conv on the channel axis with block-diagonal weights:

    conv(x_pair, diag(W, W)) == [conv(x1, W); conv(x2, W)]   (exact)

Half of each packed conv's multiply-adds multiply the structural zeros. The
convs are cuDNN's, in plain PyTorch; this path has no kernel of its own.
Packed weights are OIHW, as the port's convs hold them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .pixel_ops import pixel_shuffle


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


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return y + b


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
        hp = _conv(hp, packed[f"w_{i}"], packed[f"b_{i}"])
        hp = torch.where(hp >= 0, hp, hp * packed[f"a_{i}"])
    hp = _conv(hp, packed["w_last"], packed["b_last"])
    oc = 3 * upscale ** 2
    out = unpack_batch(hp, 2, oc)
    # the nearest-upsampled base, added before the shuffle: channel
    # c·r² + (a, b) lands at subpixel (a, b) of channel c
    out = out + torch.repeat_interleave(x, upscale * upscale,
                                        dim=-1).to(out.dtype)
    return pixel_shuffle(out, upscale)
