"""Spatial sharding of one image over the ranks of a process group, with
halo exchange.

Port of `image_restoration_tpu/parallel/spatial.py`: `halo_exchange` :25
and `spatial_sharded_apply` :50. An image is cut into row blocks, one per
rank; each rank sends its top and bottom `halo` rows to its ring
neighbours (`torch.distributed` point-to-point calls, where JAX's
`ppermute` rides the ICI), runs the network on its halo-padded block and
keeps the valid centre. The two edge ranks reflect their own border rows,
as `tiled_apply` does. Interior rows equal the unsharded forward when
`halo` covers the network's receptive field.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..utils.dist_util import get_dist_info, in_world


def halo_exchange(block: torch.Tensor, halo: int) -> torch.Tensor:
    """(N, H_local, W, C) row block → (N, H_local + 2·halo, W, C): the
    previous rank's bottom `halo` rows above it and the next rank's top
    rows below it; the first and last ranks reflect their own border."""
    rank, world = get_dist_info()
    top_rows = block[:, :halo].contiguous()   # what the rank above needs
    bot_rows = block[:, -halo:].contiguous()  # what the rank below needs
    from_top = block[:, 1:halo + 1].flip(1)
    from_bot = block[:, -halo - 1:-1].flip(1)
    ops = []
    if rank > 0:
        from_top = torch.empty_like(top_rows)
        ops += [dist.P2POp(dist.isend, top_rows, rank - 1),
                dist.P2POp(dist.irecv, from_top, rank - 1)]
    if rank < world - 1:
        from_bot = torch.empty_like(bot_rows)
        ops += [dist.P2POp(dist.isend, bot_rows, rank + 1),
                dist.P2POp(dist.irecv, from_bot, rank + 1)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return torch.cat([from_top, block, from_bot], dim=1)


def spatial_sharded_apply(fn: Callable, img: torch.Tensor, halo: int,
                          scale: int = 1) -> torch.Tensor:
    """`fn` (NHWC → NHWC, ×scale, translation-equivariant) over `img` (the
    whole (N, H, W, C) image, the same on every rank), each rank running
    its block of H/world rows with `halo` rows from its neighbours.
    Returns the whole output on every rank (the blocks gathered in rank
    order). H must divide by the world and halo be under the rows of a
    block (one neighbour each way)."""
    rank, world = get_dist_info()
    n, h, w, c = img.shape
    assert h % world == 0, f"H={h} must divide by the world {world}"
    rows = h // world
    assert halo < rows, (f"halo {halo} must be < rows/rank {rows} "
                         "(single-neighbour ring exchange)")
    block = img[:, rank * rows:(rank + 1) * rows]
    out = fn(halo_exchange(block, halo))
    out = out[:, halo * scale:out.shape[1] - halo * scale].contiguous()
    if not in_world():
        return out
    parts = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(parts, out)
    return torch.cat(parts, dim=1)
