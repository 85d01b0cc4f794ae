"""Spatial halo tiling for large-image inference.

Port of `image_restoration_tpu/parallel/tiling.py:25-93`: the image is
reflect-padded to a whole tile grid plus a halo, cut into one batch of
overlapping tiles, run in chunks of `tile_batch`, and the tiles' centers are
stitched back. Over a mesh (`parallel/mesh.py`) each chunk is split in
order over the mesh's devices and their parts run at once.

The reflect padding repeats the fold as often as needed, as `jnp.pad` and
`np.pad` do when the pad is wider than the image (a 120×360 plate at tile 512
pads 8 + 392 rows); `torch.nn.functional.pad` refuses such pads, so the
indices are built with numpy and gathered with `index_select`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .mesh import data_sharding


def _reflect_index(n: int, before: int, after: int,
                   device: torch.device) -> torch.Tensor:
    idx = np.pad(np.arange(n), (before, after), mode="reflect")
    return torch.from_numpy(idx).to(device)


def tile_image(img: torch.Tensor, tile: int, halo: int
               ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """(1|N, H, W, C) → (gh·gw·N, tile+2·halo, tile+2·halo, C) tile batch,
    tile-major (all N images of tile 0, then tile 1, …), and the
    (gh, gw, H, W) that `untile_image` needs."""
    if img.dim() == 3:
        img = img[None]
    n, h, w, c = img.shape
    gh, gw = math.ceil(h / tile), math.ceil(w / tile)
    padded = img.index_select(
        1, _reflect_index(h, halo, halo + gh * tile - h, img.device))
    padded = padded.index_select(
        2, _reflect_index(w, halo, halo + gw * tile - w, img.device))
    size = tile + 2 * halo
    tiles = [padded[:, i * tile:i * tile + size, j * tile:j * tile + size]
             for i in range(gh) for j in range(gw)]
    return torch.cat(tiles, dim=0), (gh, gw, h, w)


def untile_image(tiles: torch.Tensor, grid: Tuple[int, int, int, int],
                 tile: int, halo: int, scale: int = 1) -> torch.Tensor:
    """Crop the halo off each tile and stitch: → (N, H·scale, W·scale, C)."""
    gh, gw, h, w = grid
    t, p = tile * scale, halo * scale
    n = tiles.shape[0] // (gh * gw)
    c = tiles.shape[-1]
    centers = tiles[:, p:p + t, p:p + t, :].reshape(gh, gw, n, t, t, c)
    out = centers.permute(2, 0, 3, 1, 4, 5).reshape(n, gh * t, gw * t, c)
    return out[:, :h * scale, :w * scale, :]


def tiled_apply(fn, img: torch.Tensor, tile: int, halo: int,
                scale: int = 1, tile_batch: Optional[int] = None,
                mesh=None, axis: str = "data",
                out_halo: Optional[int] = None) -> torch.Tensor:
    """Apply `fn` (NHWC → NHWC, ×scale) tile by tile with reflect halos.

    tile_batch: run the tiles in chunks of this many (the last chunk is
    padded with zero tiles to the same size, and their outputs dropped).
    out_halo: the halo left on fn's output; 0 when fn crops it itself
    (`quantized_srvgg_forward(crop_halo=...)`). Default: halo.
    mesh: a one-process `parallel.mesh.Mesh`; tile_batch is rounded up to
    a multiple of its size (JAX's static shapes), each chunk is split in
    order over its devices, and `fn` (one callable, or one per device,
    such as the replicas of a net) runs on every part at once, each on
    its device's thread. `axis` names the mesh axis, as in JAX.
    """
    tiles, grid = tile_image(img, tile, halo)
    num = tiles.shape[0]
    tile_batch = tile_batch or num
    if mesh is not None:
        fn = _over_mesh(fn, mesh, img.device)
        tile_batch += -tile_batch % mesh.size
    outs = []
    for start in range(0, num, tile_batch):
        chunk = tiles[start:start + tile_batch]
        pad = tile_batch - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (pad,) + tuple(chunk.shape[1:]))], dim=0)
        out = fn(chunk)
        outs.append(out[:tile_batch - pad] if pad else out)
    return untile_image(torch.cat(outs, dim=0), grid, tile,
                        halo if out_halo is None else out_halo, scale)


def _over_mesh(fn, mesh, out_device) -> Callable:
    """A chunk function that splits its chunk in order over `mesh`'s
    devices, runs fn (or fn[i] on device i) on the parts at once, and
    gathers the outputs in order on `out_device`."""
    if mesh.world:
        raise ValueError("tiled_apply takes the devices of one process; "
                         "for a process group use parallel.spatial")
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * mesh.size
    split = data_sharding(mesh)

    def run(chunk):
        outs = mesh.run(fns, split(chunk))
        return torch.cat([o.to(out_device) for o in outs], dim=0)

    return run
