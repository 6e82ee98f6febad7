"""The data-parallel "mesh": one process per device over a
``torch.distributed`` process group.  Port of
``meg_decoding_tpu/core/mesh.py`` (``:25-62``).

JAX drives every device of a 1-D ``data`` mesh from one process; PyTorch's
idiom is one process per GPU, so here the mesh is this process's place in
the group: its rank, the world size, the group and the rank's device.
Parameters are replicated (every rank holds the same copy), the batch is
split along its leading axis, rank r holding rows ``[r·b, (r+1)·b)`` of a
global batch of ``n·b`` — JAX's ``P('data')`` layout.

Collectives go through the methods below, which refuse a tensor that the
group's backend does not carry: NCCL takes CUDA tensors only, gloo CPU
tensors only, so a CUDA tensor never takes a gloo collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DataMesh", "make_mesh", "shard_batch", "local_batch_size"]


@dataclass(frozen=True)
class DataMesh:
    """This rank's place in a data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None  # a ProcessGroup; None is the default group

    def _check(self, t: torch.Tensor) -> None:
        backend = dist.get_backend(self.group)
        if (backend == "nccl") != t.is_cuda:
            raise ValueError(f"a {t.device} tensor cannot take a {backend} "
                             "collective")

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce (``'sum'`` or ``'max'``), outside autograd."""
        self._check(t)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce that carries autograd: its backward SUM
        all-reduces the cotangent (each rank's loss is its share of the
        global loss)."""
        from torch.distributed.nn.functional import all_reduce

        self._check(t)
        return all_reduce(t.contiguous(), group=self.group or dist.group.WORLD)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order, with
        autograd: the backward SUM reduce-scatters the cotangent."""
        from torch.distributed.nn.functional import all_gather

        self._check(t)
        return torch.cat(all_gather(t.contiguous(),
                                    group=self.group or dist.group.WORLD), 0)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._check(t)
        dist.broadcast(t, src=src, group=self.group)
        return t


def make_mesh(device: torch.device, group=None) -> DataMesh:
    """The mesh of this process in ``group`` (the default group when None),
    which must be initialized (``parallel/dp.py:maybe_distributed_init``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    return DataMesh(rank=dist.get_rank(group), world_size=dist.get_world_size(group),
                    device=torch.device(device), group=group)


def local_batch_size(global_batch: int, mesh: DataMesh) -> int:
    n = mesh.world_size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of every element of a batch tuple (tensors or numpy
    arrays of one global batch, the same on every rank), tensors moved to
    the rank's device; the global batch must divide the world size."""
    def take(x):
        b = local_batch_size(len(x), mesh)
        part = x[mesh.rank * b:(mesh.rank + 1) * b]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(mesh.device, non_blocking=True)

    return tuple(take(x) for x in batch)
