"""Seeded tensors for both sides of a cell: weights and input pools.

Every draw comes from a `torch.Generator` seeded with a sub-seed of the
run's `--seed`, on the device the run measures, in a few large calls.
The same seed gives the same tensors on the same device type.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw named `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def draw_params(schema: Iterable[Tuple[str, tuple, float, float]], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """{name: mean + std·N(0, 1)} for every (name, shape, mean, std), float32,
    from one normal draw over all of them."""
    schema = list(schema)
    sizes = [math.prod(shape) for _, shape, _, _ in schema]
    z = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                    device=device)
    out, off = {}, 0
    for (name, shape, mean, std), n in zip(schema, sizes):
        out[name] = z[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def smooth_images(n: int, h: int, w: int, seed: int, tag: str, device,
                  cell: int = 8, grain: float = 12.0) -> torch.Tensor:
    """(n, h, w, 3) uint8 images on `device`: a coarse random field (one
    value per `cell` pixels, bilinear between) for the shapes of a scene,
    plus per-pixel grain of std `grain` levels."""
    g = generator(seed, tag, device)
    ch, cw = -(-h // cell) + 1, -(-w // cell) + 1
    coarse = torch.rand((n, 3, ch, cw), generator=g, device=device) * 255.0
    field = torch.nn.functional.interpolate(
        coarse, size=(ch * cell, cw * cell), mode="bilinear",
        align_corners=False)[:, :, :h, :w]
    noise = torch.randn((n, 3, h, w), generator=g, device=device) * grain
    img = (field + noise).clamp_(0.0, 255.0).round_().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()
