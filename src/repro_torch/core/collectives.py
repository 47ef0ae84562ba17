"""Every collective of the sharded layer, counted.

The JAX package's shard programs combine with ``jax.lax.psum`` /
``pmax`` / ``pmin`` (:func:`mesh_combine`), gather with ``all_gather``,
exchange partial products with ``all_to_all`` and ring-shift B blocks with
``ppermute`` inside ``shard_map``.  The port's ranks call the same
collectives on the mesh's process group, through this module only, so
:data:`COLLECTIVE_STATS` counts every call a ``DistAssoc`` entry point
makes — the number the JAX package's ``@contract(collectives=…)`` declares
for it.

The JAX package is single-controller: before a product it reads every
shard to the host (A's rows and contraction ranks, a resident B's triples)
for its cost model.  Here each rank holds only its own shard, so those
host reads become collectives of their own — the *prologue* collectives —
counted apart in :data:`PROLOGUE_STATS` (``prologue=True``), so the
program count stays comparable with the JAX ``@contract``.  An
``all_gather`` or ``all_reduce`` of one rank is the identity, so at one
rank a prologue collective is skipped and not counted.

The NaN rule of the combine follows the reference.  Inside ``shard_map``
on several shards, the CPU ``pmax``/``pmin`` treat a NaN partial as absent
(partials ``[NaN, 1, 1, 1]`` give 1, a column NaN on every shard gives the
⊕ identity, ``-inf`` for max and ``+inf`` for min), while on one shard the
collective is the identity and NaN stays; ``psum`` keeps NaN on both.  So
on a mesh of more than one rank :func:`mesh_combine` writes the ⊕ identity
over NaN in a max/min partial before its one ``all_reduce``, and the
result no longer depends on what gloo or NCCL do with NaN.

The serve engine's control channel (:func:`broadcast_bytes`, rank 0's
admitted requests sent to the other ranks) is counted apart again, in
:data:`BROADCAST_STATS`: it carries requests, not data of a shard
program, so program counts stay comparable with the JAX ``@contract``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh
from .semiring import Semiring

__all__ = ["BROADCAST_STATS", "COLLECTIVE_STATS", "PROLOGUE_STATS",
           "all_gather", "all_reduce", "all_to_all", "broadcast_bytes",
           "collective_count", "mesh_combine", "prologue_count",
           "reset_collective_stats", "ring_shift"]

# program collectives called on this rank, by collective
COLLECTIVE_STATS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                    "all_to_all": 0, "ring_shift": 0}
# prologue collectives (the single controller's host reads), by collective
PROLOGUE_STATS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
# control-channel messages on this rank (sent or received)
BROADCAST_STATS: Dict[str, int] = {"broadcast": 0}
_LOCK = threading.Lock()

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
# the ⊕ identity written over a NaN partial before a max/min combine
_NAN_IDENTITY = {"max": -float("inf"), "min": float("inf")}


def _bump(name: str, prologue: bool = False) -> None:
    with _LOCK:
        (PROLOGUE_STATS if prologue else COLLECTIVE_STATS)[name] += 1


def collective_count() -> int:
    """Program collectives called on this rank since the last reset."""
    with _LOCK:
        return sum(COLLECTIVE_STATS.values())


def prologue_count() -> int:
    """Prologue collectives called on this rank since the last reset."""
    with _LOCK:
        return sum(PROLOGUE_STATS.values())


def reset_collective_stats() -> None:
    with _LOCK:
        for stats in (COLLECTIVE_STATS, PROLOGUE_STATS, BROADCAST_STATS):
            for k in stats:
                stats[k] = 0


def all_reduce(x: torch.Tensor, mesh: Mesh, kind: str = "sum", *,
               prologue: bool = False) -> torch.Tensor:
    """``x`` reduced over the ranks in place with SUM, MAX or MIN
    (``kind``), and returned; a prologue reduction of one rank is
    skipped."""
    mesh.check(x)
    if prologue and mesh.size == 1:
        return x
    x = x.contiguous()
    opts = dist.AllreduceOptions()
    opts.reduceOp = _REDUCE_OPS[kind]
    _bump("all_reduce", prologue)
    mesh.group.allreduce([x], opts).wait()
    return x


def mesh_combine(x: torch.Tensor, mesh: Mesh, sr: Semiring) -> torch.Tensor:
    """Cross-shard ⊕ of a partial ``x`` as the one ``all_reduce`` matching
    ``sr.add_kind`` (SUM / MAX / MIN); every rank gets the result.

    The single combine step of the Graphulo pushdown pattern: shard-local
    partials, or disjoint-support rows for which ⊕-with-zero is a
    concatenation, merge in one collective.  ``x`` is reduced in place and
    returned.  On more than one rank a max/min partial has its NaN
    replaced by the ⊕ identity first (the reference's rule, see the
    module docstring).
    """
    mesh.check(x)
    x = x.contiguous()
    ident = _NAN_IDENTITY.get(sr.add_kind)
    if mesh.size > 1 and ident is not None and x.is_floating_point():
        x.masked_fill_(torch.isnan(x), ident)
    return all_reduce(x, mesh, sr.add_kind)


def all_gather(x: torch.Tensor, mesh: Mesh, *,
               prologue: bool = False) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), stacked on a new leading
    axis in rank order: ``[world size, *x.shape]``; a prologue gather of
    one rank is skipped."""
    mesh.check(x)
    if prologue and mesh.size == 1:
        return x[None]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    _bump("all_gather", prologue)
    mesh.group.allgather([out], [x]).wait()
    return torch.stack(out)


def broadcast_bytes(data: Optional[bytes], mesh: Mesh) -> bytes:
    """One control message from rank 0 to every rank: ``data`` is read on
    rank 0 only, and every rank returns the same bytes.

    The framing is fixed: an int64 length, then the bytes, as two
    broadcasts of the group on the mesh's device; together they count as
    one message in :data:`BROADCAST_STATS`.  At one rank nothing is sent
    and nothing is counted."""
    if mesh.size == 1:
        return bytes(data)
    root = mesh.rank == 0
    n = torch.tensor([len(data) if root else 0], dtype=torch.int64,
                     device=mesh.device)
    _broadcast(n, mesh)
    size = int(n[0])
    if root:
        buf = torch.tensor(bytearray(data), dtype=torch.uint8,
                           device=mesh.device)
    else:
        buf = torch.empty(size, dtype=torch.uint8, device=mesh.device)
    if size:
        _broadcast(buf, mesh)
    with _LOCK:
        BROADCAST_STATS["broadcast"] += 1
    return bytes(data) if root else buf.cpu().numpy().tobytes()


def _broadcast(x: torch.Tensor, mesh: Mesh) -> None:
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    opts.rootTensor = 0
    mesh.group.broadcast([x], opts).wait()


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The packed exchange of the all-to-all product: ``x`` is
    ``[world size, ...]``, slice ``d`` goes to rank ``d``, and slice ``s``
    of the result is what rank ``s`` sent here (``jax.lax.all_to_all``
    with ``split_axis=concat_axis=0``, tiled)."""
    mesh.check(x)
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all of {x.shape[0]} slices on "
                         f"{mesh.size} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    _bump("all_to_all")
    mesh.group.alltoall_base(out, x, [], [], dist.AllToAllOptions()).wait()
    return out


def ring_shift(x: torch.Tensor, mesh: Mesh, dest: int, src: int
               ) -> torch.Tensor:
    """``ppermute`` of one block: this rank's ``x`` goes to rank ``dest``
    and the block rank ``src`` sends comes back (same shape on every
    rank).  One uneven ``alltoall_base`` — the whole block to one rank,
    nothing to the rest — so no blocking send/recv pair can deadlock."""
    mesh.check(x)
    x = x.contiguous()
    n = x.shape[0]
    send = _one_hot_splits(mesh.size, dest, n)
    recv = _one_hot_splits(mesh.size, src, n)
    out = torch.empty_like(x)
    _bump("ring_shift")
    mesh.group.alltoall_base(out, x, recv, send,
                             dist.AllToAllOptions()).wait()
    return out


def _one_hot_splits(size: int, at: int, n: int) -> Sequence[int]:
    splits = [0] * size
    splits[at] = n
    return splits
