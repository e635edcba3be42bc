"""The series mesh: the shard axis over the processes of a process group.

Port of ``m3_tpu/parallel/mesh.py``. The reference maps the shard axis onto
a 1-D ``jax.sharding.Mesh`` axis named "shard": series batches are laid out
[series, ...] and split along axis 0, and cross-series totals ride the chips'
interconnect as psum/pmin/pmax over that axis. Here the axis is an
initialised ``torch.distributed`` process group, one process a rank: each
rank holds its slice of axis 0 on its own device, and the totals are NCCL
(or, on the CPU, gloo) all-reduces outside the kernels.

No process group is created here: the caller calls
``torch.distributed.init_process_group`` with its own address, rank and
world size, and ``series_mesh`` raises when there is none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.distributed as dist

SHARD_AXIS = "shard"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class SeriesMesh:
    """A 1-D mesh over the ranks of ``group``: this process is rank
    ``rank`` of ``size`` and holds its slice of the series on ``device``."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis_names: ClassVar[tuple] = (SHARD_AXIS,)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` (on this rank's device) reduced over the mesh by ``op``
        ("sum", "min" or "max"): a new tensor of x's shape on every rank."""
        out = x.reshape(-1).clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out.reshape(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on each) concatenated along axis 0
        in rank order, on every rank."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def series_mesh(device=None) -> SeriesMesh:
    """The mesh over the world group of the initialised process group.
    ``device``: this rank's device; by default ``cuda:{rank % device_count}``
    under NCCL and the CPU under any other backend. Raises RuntimeError when
    no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "series_mesh needs an initialised torch.distributed process group: call "
            "init_process_group(backend, init_method or store, rank=, world_size=) first")
    group = dist.group.WORLD
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if device is None:
        if dist.get_backend(group) == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    return SeriesMesh(group=group, rank=rank, size=size, device=torch.device(device))


def series_sharding(mesh: SeriesMesh):
    """This rank's slice of axis 0: ``shard(x)`` takes rows [rank * n / size,
    (rank + 1) * n / size) of an array or tensor of n rows (n a multiple of
    the mesh size, else ValueError); ``shard.rows(n)`` is that slice."""
    return _Shard(mesh.rank, mesh.size)


def replicated(mesh: SeriesMesh):
    """Every rank holds the whole array: the identity."""
    return lambda x: x


class _Shard:
    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over a mesh of {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def __call__(self, x):
        return x[self.rows(x.shape[0])]
