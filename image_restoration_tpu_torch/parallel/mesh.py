"""Device meshes for serving and training over several devices.

Port of `image_restoration_tpu/parallel/mesh.py`: `make_mesh` :23,
`data_sharding` :38, `replicate` :43 and `shard_batch` :47. JAX builds a
`jax.sharding.Mesh` and XLA places the shards; here a mesh is either

  * the devices of one process (serving: one replica of a net per device,
    each run from its own worker thread, `Mesh.run`), or
  * the world of a `torch.distributed` process group (training: this
    process is one rank and holds one device).

Both split a batch along axis 0 into contiguous equal parts, in order.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.dist_util import get_dist_info, in_world, local_device


class Mesh:
    """A 1-D mesh. With `world` False, `devices` are this process's (a
    device may repeat, which CPU tests use); with `world` True it is the
    process group's world and `devices` holds this rank's device."""

    def __init__(self, devices: Sequence, axis_names=("data",),
                 world: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.world = world
        self._pools: Optional[List[ThreadPoolExecutor]] = None

    @property
    def size(self) -> int:
        return get_dist_info()[1] if self.world else len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def run(self, fns: Sequence[Callable], parts: Sequence) -> list:
        """fns[i](parts[i]) for every device i at once, each on its own
        worker thread (cuDNN keeps its plans per thread); the results in
        order."""
        if self._pools is None:
            self._pools = [ThreadPoolExecutor(1) for _ in self.devices]
        futures = [pool.submit(fn, part)
                   for pool, fn, part in zip(self._pools, fns, parts)]
        return [f.result() for f in futures]

    def close(self) -> None:
        for pool in self._pools or ():
            pool.shutdown()
        self._pools = None


def make_mesh(devices: Optional[Sequence] = None,
              axes: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over `devices`; by default the world of the process group
    when one is up, else every CUDA device of this process (the CPU when
    there is none)."""
    if devices is not None:
        return Mesh(devices, axes)
    if in_world():
        return Mesh([local_device()], axes, world=True)
    n = torch.cuda.device_count()
    return Mesh([f"cuda:{i}" for i in range(n)] or ["cpu"], axes)


def _split(x, size: int, index: int):
    if x.shape[0] % size:
        raise ValueError(f"a batch of {x.shape[0]} does not split evenly "
                         f"over {size} devices")
    n = x.shape[0] // size
    return x[index * n:(index + 1) * n]


def data_sharding(mesh: Mesh) -> Callable:
    """The batch split of `mesh`: x → this rank's rows (a world), or the
    list of per-device parts, each on its device (one process)."""
    if mesh.world:
        return lambda x: _split(x, mesh.size, get_dist_info()[0])
    return lambda x: [_to(_split(x, mesh.size, i), d)
                      for i, d in enumerate(mesh.devices)]


def replicate(x, mesh: Mesh):
    """A copy of a tensor or a module on every device of a one-process
    mesh; in a world every rank already holds its own copy."""
    if mesh.world:
        return x
    if isinstance(x, torch.nn.Module):
        return [copy.deepcopy(x).to(d) for d in mesh.devices]
    return [_to(x, d) for d in mesh.devices]


def shard_batch(batch: dict, mesh: Mesh):
    """A dict of arrays or tensors split along axis 0 over `mesh` (entries
    that are not arrays, such as paths, are dropped, as in JAX): this
    rank's dict in a world, else one dict per device."""
    split = data_sharding(mesh)
    arrays = {k: split(v) for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    if mesh.world:
        return arrays
    return [{k: v[i] for k, v in arrays.items()} for i in range(mesh.size)]


def _to(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)
