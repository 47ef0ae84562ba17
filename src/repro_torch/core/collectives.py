"""Every collective of the sharded layer, counted.

The JAX package's shard programs combine with ``jax.lax.psum`` /
``pmax`` / ``pmin`` (:func:`mesh_combine`) and gather with ``all_gather``
inside ``shard_map``.  The port's ranks call the same two collectives on
the mesh's process group, through this module only, so
:data:`COLLECTIVE_STATS` counts every call a ``DistAssoc`` entry point
makes — the number the JAX package's ``@contract(collectives=…)`` declares
for it.

The combine follows the reference in its form: one ``all_reduce`` with
SUM, MAX or MIN, and what the backend's MAX/MIN do with a NaN partial is
what the result holds.  On the CPU the two differ there: gloo keeps a NaN
that rank 0 holds and drops one that another rank holds, while
``pmax``/``pmin`` inside ``shard_map`` drop it from any shard.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch
import torch.distributed as dist

from .mesh import Mesh
from .semiring import Semiring

__all__ = ["COLLECTIVE_STATS", "all_gather", "collective_count",
           "mesh_combine", "reset_collective_stats"]

# calls made on this rank, by collective
COLLECTIVE_STATS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
_LOCK = threading.Lock()

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _bump(name: str) -> None:
    with _LOCK:
        COLLECTIVE_STATS[name] += 1


def collective_count() -> int:
    """Collectives called on this rank since the last reset."""
    with _LOCK:
        return sum(COLLECTIVE_STATS.values())


def reset_collective_stats() -> None:
    with _LOCK:
        for k in COLLECTIVE_STATS:
            COLLECTIVE_STATS[k] = 0


def mesh_combine(x: torch.Tensor, mesh: Mesh, sr: Semiring) -> torch.Tensor:
    """Cross-shard ⊕ of a partial ``x`` as the one ``all_reduce`` matching
    ``sr.add_kind`` (SUM / MAX / MIN); every rank gets the result.

    The single combine step of the Graphulo pushdown pattern: shard-local
    partials, or disjoint-support rows for which ⊕-with-zero is a
    concatenation, merge in one collective.  ``x`` is reduced in place and
    returned.
    """
    mesh.check(x)
    x = x.contiguous()
    opts = dist.AllreduceOptions()
    opts.reduceOp = _REDUCE_OPS[sr.add_kind]
    _bump("all_reduce")
    mesh.group.allreduce([x], opts).wait()
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), stacked on a new leading
    axis in rank order: ``[world size, *x.shape]``."""
    mesh.check(x)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    _bump("all_gather")
    mesh.group.allgather([out], [x]).wait()
    return torch.stack(out)
