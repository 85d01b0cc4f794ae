"""Process-group helpers for training over several devices.

Port of `image_restoration_tpu/utils/dist_util.py:14-48` and the reference
BasicSR's `init_dist` for the pytorch launcher (basicsr/utils/dist_util.py
:10-30). JAX shards one global batch over a device mesh and XLA inserts
the collectives; here each device is one process of a `torch.distributed`
world started by `torchrun`, and the trainers make the same global-batch
step from explicit collectives:

  * `average_gradients` all-reduces every gradient to the world's mean
    after the backward passes of an update (R1's and the path-length
    term's `create_graph` backward included, which DDP's reducer does not
    synchronize);
  * `all_reduce_sum`, `world_mean` and `gather_batch` are differentiable
    (their backward is a collective too), for the terms of a step that
    read the whole batch: train-mode BatchNorm statistics, the StyleGAN2
    D's minibatch standard deviation, the relativistic GAN means, the
    detector's normalizers;
  * `rank_rows` keeps a rank's rows of what was drawn for the whole global
    batch, so per-sample random draws are those of one process.

Without a process group `get_dist_info()` is (0, 1) and every helper is
the identity; in a process group every helper runs its collective, a world
of one included (which is how one card exercises these paths).
"""

from __future__ import annotations

import functools
import os
from typing import Iterable, Tuple

import torch
import torch.distributed as dist


def init_dist(backend: str = "nccl", init_method: str = "env://",
              **kwargs) -> Tuple[int, int]:
    """Join the world `torchrun` started (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT in the environment) and, for nccl, pin this
    process to `cuda:LOCAL_RANK`. Returns (rank, world). gloo runs on the
    CPU, for tests. A world already up is kept."""
    if in_world():
        return get_dist_info()
    if init_method == "env://" and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "init_dist: no torch.distributed world in the environment; "
            "start the processes with torchrun (e.g. torchrun "
            "--nproc_per_node N -m image_restoration_tpu_torch.train ...)")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend, init_method=init_method,
                            **kwargs)
    return get_dist_info()


def in_world() -> bool:
    """Whether this process is in a `torch.distributed` process group."""
    return dist.is_available() and dist.is_initialized()


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is up."""
    if in_world():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def master_only(func):
    """Run `func` on rank 0 only; other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper


def local_device(device=None) -> torch.device:
    """This process's device in a world: `device` when given, else
    `cuda:LOCAL_RANK`."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


class _AllReduceSum(torch.autograd.Function):
    """Σ over the world; its backward is the same all-reduce of the
    gradients, itself differentiable, so a double backward (R1, the path
    length) is a collective too."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the world of `x`; differentiable (the gradient of each rank's
    input is the world's sum of the output gradients)."""
    return _AllReduceSum.apply(x) if in_world() else x


def world_mean(x: torch.Tensor) -> torch.Tensor:
    """The world's mean of `x` (the mean of equal per-rank means is the
    global batch's mean); differentiable."""
    return all_reduce_sum(x) / get_dist_info()[1] if in_world() else x


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The world's `x` concatenated along axis 0 in rank order (equal
    shapes on every rank); differentiable: each rank's input gets the
    world's sum of the gradients of its rows. Built from `all_reduce_sum`
    of a zero-padded copy, so its double backward is a collective too."""
    if not in_world():
        return x
    rank, world = get_dist_info()
    n = x.shape[0]
    pad = [0, 0] * (x.dim() - 1) + [rank * n, (world - 1 - rank) * n]
    return all_reduce_sum(torch.nn.functional.pad(x, pad))


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's `.grad` ← the world's mean of it, in one flat
    all-reduce per dtype (a missing gradient counts as zero)."""
    if not in_world():
        return
    world = get_dist_info()[1]
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def reduce_loss_dict(loss_dict) -> dict:
    """Scalar loss tensors (on one device) → floats, with one copy to the
    host; in a world, the world's means (every rank must call it)."""
    if not loss_dict:
        return {}
    vals = torch.stack([v.detach().float().reshape(())
                        for v in loss_dict.values()])
    if in_world():
        dist.all_reduce(vals)
        vals /= get_dist_info()[1]
    return dict(zip(loss_dict.keys(), vals.tolist()))


def rank_rows(tree, n_global: int, rank: int = None, world: int = None):
    """A rank's rows of a (nested dict of) tensors drawn for the global
    batch: every tensor whose first axis is `n_global` is cut to this
    rank's contiguous 1/world of it; others (scalars, shared draws) pass."""
    if rank is None:
        rank, world = get_dist_info()
    if isinstance(tree, dict):
        return {k: rank_rows(v, n_global, rank, world)
                for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.dim() and tree.shape[0] == n_global:
        n = n_global // world
        return tree[rank * n:(rank + 1) * n]
    return tree


def check_global_batch(batch: int, world: int) -> int:
    """The rows of `batch` (the global batch) each of `world` ranks reads;
    raises unless it divides evenly."""
    if batch % world:
        raise ValueError(f"the global batch {batch} does not divide over a "
                         f"world of {world}")
    return batch // world
