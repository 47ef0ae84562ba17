"""The device mesh of the sharded layer: one process (rank) per shard.

The JAX package's ``DistAssoc`` is single-controller: one program holds
every shard as a slice of stacked ``[P, cap]`` arrays on a
``jax.make_mesh((P,), ("data",))``.  The port runs SPMD instead, one
process per shard, as Accumulo runs one tablet server per tablet: each
rank holds its own shard on its own device, and the shards meet only in
the collectives of :mod:`repro_torch.core.collectives`.

A :class:`Mesh` is the counterpart of the JAX mesh: the process group, this
process's rank, ``shape["data"]`` (the world size) and the rank's device.
The backend follows the device — NCCL for ``cuda:{local rank}``, gloo for
``cpu``.  A gloo group cannot ``all_gather`` CUDA tensors, so a gloo mesh
on a CUDA device raises; nothing stages through the host to get round it.

The group is a process group object of its own, not
``torch.distributed``'s default group, so making a mesh leaves the global
state of ``torch.distributed`` untouched: a test process can hold one next
to any other code.  :func:`make_mesh` builds it from a ``FileStore``: with
one rank, in a temporary directory (no network); with several, on a file
path that every rank is given.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .assoc_tensor import resolve_device

__all__ = ["Mesh", "make_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group with this process's rank and device.

    Two meshes are equal only if they are the same object, as two process
    groups are two sets of communicators."""

    group: object          # a torch.distributed process group backend
    rank: int
    size: int
    device: torch.device
    backend: str           # "nccl" or "gloo"

    def __post_init__(self):
        if self.backend == "gloo" and self.device.type != "cpu":
            raise ValueError(
                f"a gloo mesh carries CPU tensors only (gloo cannot "
                f"all_gather {self.device.type} tensors); build the mesh "
                f"on a CUDA device to get an NCCL group")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh carries CUDA tensors only")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside world size {self.size}")

    @property
    def shape(self) -> dict:
        """``{"data": world size}``, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.size}

    def check(self, t: torch.Tensor) -> None:
        """Raise unless ``t`` lies on this rank's device."""
        if t.device != self.device:
            raise ValueError(
                f"tensor on {t.device} given to a {self.backend} mesh on "
                f"{self.device}")

    def close(self) -> None:
        """Release the group's communicators (NCCL); a no-op for gloo."""
        shutdown = getattr(self.group, "shutdown", None)
        if self.backend == "nccl" and shutdown is not None:
            shutdown()


def make_mesh(device="cuda", *, rank: int = 0, world_size: int = 1,
              store_path: Optional[str] = None,
              local_rank: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """A mesh of ``world_size`` ranks, this process being ``rank``.

    ``device="cuda"`` (the default) puts the rank on ``cuda:{local_rank}``
    (``local_rank`` defaults to ``rank``) with an NCCL group and raises
    without a card; ``device="cpu"`` gives a gloo group.  ``store_path`` is
    the ``FileStore`` file every rank opens; with one rank it may be left
    out and a temporary directory holds it.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank if local_rank is None else local_rank)
    if store_path is None:
        if world_size != 1:
            raise ValueError("a mesh of several ranks needs the store_path "
                             "that every rank opens")
        store_path = os.path.join(tempfile.mkdtemp(prefix="d4m_mesh_"),
                                  "store")
    store = dist.FileStore(store_path, world_size)
    store.set_timeout(timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        group = dist.ProcessGroupNCCL(store, rank, world_size)
        backend = "nccl"
        # NCCL makes its communicator at the first collective (about half
        # a second on one H100): make it here, not in a user's first
        # reduction
        group.allreduce([torch.zeros(1, device=dev)],
                        dist.AllreduceOptions()).wait()
    else:
        group = dist.ProcessGroupGloo(store, rank, world_size,
                                      timedelta(seconds=timeout_s))
        backend = "gloo"
    return Mesh(group, rank, world_size, dev, backend)
