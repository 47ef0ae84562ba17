"""Distributed associative arrays: the "Distributed" D of D4M, one rank per
shard.

Historically D4M distributes via Accumulo tablet servers: tables are
row-range-partitioned and algebra pushes down to the servers (Graphulo).
A ``DistAssoc`` is an ``AssocTensor`` whose COO triples are **row-rank-range
partitioned over the ranks of a** :class:`~repro_torch.core.mesh.Mesh`
(tablet ↔ shard ↔ rank).  Each rank holds its own shard as an
``AssocTensor`` of capacity ``cap`` on its own device; keyspaces, row
bounds and ``cap`` are host metadata that every rank computes alike from
the same triples, so every rank passes the same triples to
:meth:`DistAssoc.from_triples` (as the single controller of the JAX
package does).  The paper's operations decompose as:

  * element-wise ⊕ / ⊗ — row partitions are disjoint and aligned, so both
    are one shard-local canonical merge (zero collectives);
  * selection and scalar assignment — the selector compiles on host
    against the (replicated) keyspaces, then each rank masks its own
    triples through the range-mask kernel (zero collectives);
  * global reductions (row/col ⊕-sums, degrees, ``A ⊗.⊕ x``) — a local
    segment scatter plus exactly **one** collective
    (:func:`repro_torch.core.collectives.mesh_combine`);
  * ``gather_replicated`` / ``to_assoc`` — one ``all_gather``.

  * array product ``A ⊗.⊕ B`` (``matmul``, ``matmul_reduce``, ``sqout``,
    ``sqin``, ``@``) under three *communication strategies*, chosen per
    multiply by the host cost model
    (:func:`repro_torch.core.spgemm.plan_from_summaries`):

    - ``replicate`` — B on every rank, each rank computes the product of
      its own rows (an expand-join, or above
      :data:`~repro_torch.core.spgemm.BSR_AUTO_EXPAND` products the
      tiled pair list through the ``bsr_pairlist`` kernel); row supports
      are disjoint, so the result is row-sharded on A's boundaries;
    - ``all_to_all`` — B stays sharded by contraction range (a resident
      ``DistAssoc`` B in place); A's triples are gathered to every rank,
      each rank expand-joins them against its own B block, buckets the
      partial products by destination row shard and one packed
      ``all_to_all`` delivers them for the ⊕-merge;
    - ``2d`` — a ``(pr, pc)`` grid: B splits into ``pc`` contraction
      blocks, A never moves, and ``pc`` rounds of local expand-join
      interleave with ``pc − 1`` ring shifts of the packed block.

The shard programs below are plain functions of one rank's tensors, named
after the JAX package's ``shard_map`` programs.

**Collectives of the product.**  The JAX ``_matmul_setup`` reads every
shard to its single controller; here those reads become *prologue*
collectives, counted apart from the *program* collectives the JAX
``@contract`` declares (``collectives.PROLOGUE_STATS``).  Every rank passes the same B when B is an
``AssocTensor`` or host ``Assoc`` (as every rank passes the same triples
to ``from_triples``); a resident ``DistAssoc`` B is gathered by one
``all_gather`` of its packed shard.  Each rank reduces its shard to one
int64 summary vector (:func:`repro_torch.core.spgemm.dist_summary`), one
``all_gather`` stacks them, and every rank runs the same plan, so every
rank picks the same strategy and buffer sizes; where the replicate expand
exceeds 4096, each rank estimates its own output and one ``all_reduce``
MAX gives the common capacity.  At one rank every prologue collective is
skipped (the identity).  For P > 1:

entry point: JAX ``@contract`` / port program collectives / port prologue
collectives —

* ``matmul``, replicate (``coo`` or ``bsr``): 0 / 0 / 1 summary
  ``all_gather`` and 1 overflow ``all_reduce`` MAX, +1 out-cap
  ``all_reduce`` MAX when the expand exceeds 4096, +1 B ``all_gather`` if
  B is resident;
* ``matmul``, ``all_to_all``: 1 / 1 ``all_to_all`` / as replicate, +1 A
  ``all_gather``;
* ``matmul``, ``2d`` (pr, pc): pc − 1 / pc − 1 ``ring_shift`` / as
  replicate;
* ``matmul_reduce``, replicate or ``all_to_all``: 1 / 1 ``all_reduce`` /
  1 summary ``all_gather``, +1 B if resident, +1 A for ``all_to_all``;
* ``sqout``: 1 (the fused reduce program) / the product's (1
  ``all_reduce`` with ``reduce=``) plus ``gather_replicated``'s 1
  ``all_gather`` / the product's;
* ``sqin``: 1 (the same program) / ``gather_replicated``'s 1
  ``all_gather`` / none.

``sqin`` runs on the gathered, replicated array — the device layer's
product on every rank, as the JAX ``sqin`` runs ``AssocTensor`` products
— so its product makes no collective; the JAX ``@contract`` of ``sqout``
and ``sqin`` counts the fused reduce program its probe lowers.  The
lazy select→product gathers a dist B to every rank first (one
``all_gather``), as the JAX planner's dist branch replicates it.
An overflow of ``out_capacity_per_shard`` is global, as the reference's
(its single controller reads every shard's ``true_nnz``): one prologue
``all_reduce`` MAX of a one-element flag ORs it over the ranks, so
``result.overflow`` is the same on every rank; the rank whose shard
overflowed warns.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import contract

from .assoc_tensor import (AssocTensor, _bump_dispatch, _upload_map,
                           coo_axis_mask_keep, coo_compact, coo_mask_keep,
                           coo_range_keep, resolve_device)
from .collectives import (all_gather, all_reduce, all_to_all, mesh_combine,
                          ring_shift)
from .coo import SENT, bucket_coo_by_range, dedup_sorted_coo, expand_join_coo
from .expr import EwiseAdd, EwiseMul, MatMul, Select, Source
from .keyspace import KeySpace
from .mesh import Mesh
from .semiring import PLUS_TIMES, get_semiring, scatter_combine
from .spgemm import (BSR_AUTO_EXPAND, _cap8, _stage, _upload,
                     bsr_tiles_coo, dist_summary, estimate_out_nnz,
                     pack_b_tiles, pad_to_cap, plan_from_summaries,
                     plan_matmul)

__all__ = ["DistAssoc"]

_MATMUL_IMPLS = ("auto_dist", "replicate", "all_to_all", "2d", "auto", "coo",
                 "bsr")
_KERNEL_IMPLS = ("auto", "cuda", "ref")
# replicate expand sizes up to this take the expand size as the output
# capacity; past it each rank estimates its own shard's output
_OUT_CAP_ESTIMATE = 1 << 12


# ---------------------------------------------------------------------------
# Shard programs: one rank's tensors in, one rank's tensors out.  Those that
# reduce end in the one collective.
# ---------------------------------------------------------------------------

def _col_reduce_prog(mesh: Mesh, sr, n: int, cols, vals, rows):
    """⊕ of the shard's values per key in ``cols`` → dense ``[n]``, then
    the one combine."""
    ok = rows != SENT
    vec = torch.full((n,), sr.zero, dtype=vals.dtype, device=vals.device)
    vec = scatter_combine(vec, torch.where(ok, cols, n),
                          torch.where(ok, vals, sr.zero), sr)
    return mesh_combine(vec, mesh, sr)


def _col_degree_prog(mesh: Mesh, n: int, cols, rows):
    """Stored entries per column → int32 ``[n]``, then one SUM."""
    ok = rows != SENT
    vec = torch.zeros(n, dtype=torch.int32, device=cols.device)
    vec = scatter_combine(vec, torch.where(ok, cols, n), ok.to(torch.int32),
                          PLUS_TIMES)
    return mesh_combine(vec, mesh, PLUS_TIMES)


def _matvec_prog(mesh: Mesh, sr, n: int, dt, rows, cols, vals, x):
    """The shard's rows of ``A ⊗.⊕ x`` in ``dt``, then the one combine."""
    ok = rows != SENT
    xv = x[cols.clamp(0, x.shape[0] - 1).long()].to(dt)
    contrib = sr.mul(torch.where(ok, vals, sr.zero).to(dt), xv)
    y = torch.full((n,), sr.zero, dtype=dt, device=vals.device)
    y = scatter_combine(y, torch.where(ok, rows, n),
                        torch.where(ok, contrib, sr.zero), sr)
    return mesh_combine(y, mesh, sr)


def _shard_selection_keep(loc: AssocTensor, row_gather: bool,
                          col_gather: bool, boxes, rm, cm) -> torch.Tensor:
    """Shard-local keep mask for a compiled selection — the one body shared
    by ``__getitem__`` and ``__setitem__`` (range kernel per box, OR-composed,
    and a membership gather for a scattered axis, exactly as
    ``AssocTensor._selection_keep``).  ``boxes`` is the ``[k, 4]`` box list
    of ``select.plan_boxes``."""
    if row_gather and col_gather:
        return coo_mask_keep(loc.rows, loc.cols, rm, cm)
    keep = coo_range_keep(loc.rows, loc.cols, boxes[0])
    for b in boxes[1:]:
        keep = keep | coo_range_keep(loc.rows, loc.cols, b)
    if row_gather:
        keep = keep & coo_axis_mask_keep(loc.rows, rm)
    if col_gather:
        keep = keep & coo_axis_mask_keep(loc.cols, cm)
    return keep


def _check_aligned(locs) -> None:
    """Element-wise dist operands share their keyspaces, and so their row
    partition: their ranks mean the same keys on every rank."""
    first = locs[0]
    if any(t.row_space != first.row_space or t.col_space != first.col_space
           for t in locs[1:]):
        raise ValueError("element-wise DistAssoc operands must share their "
                         "keyspaces (and so their row partition)")


def _reduce_add_n_prog(mesh: Mesh, sr, axis: int, n_out: int, locs):
    """Fused ``⊕-reduce(t₁ ⊕ t₂ ⊕ …, axis)`` over aligned shards: every
    term's triples scatter into one partial vector, then the one combine
    (the planner's Reduce-through-EwiseAdd rewrite)."""
    _check_aligned(locs)
    vec = torch.full((n_out,), sr.zero, dtype=torch.float32,
                     device=mesh.device)
    for loc in locs:
        ok = loc.rows != SENT
        keys = loc.rows if axis == 1 else loc.cols
        vec = scatter_combine(vec, torch.where(ok, keys, n_out),
                              torch.where(ok, loc.vals, sr.zero), sr)
    return mesh_combine(vec, mesh, sr)


def _select_prog(loc: AssocTensor, row_gather: bool, col_gather: bool,
                 boxes, rm, cm) -> AssocTensor:
    """Shard-local selection (``__getitem__``'s executor)."""
    keep = _shard_selection_keep(loc, row_gather, col_gather, boxes, rm, cm)
    r, c, v, nnz = coo_compact(loc.rows, loc.cols, loc.vals, keep)
    return AssocTensor(r, c, v, nnz, loc.row_space, loc.col_space,
                       loc.val_space)


def _setvals_prog(loc: AssocTensor, row_gather: bool, col_gather: bool,
                  boxes, rm, cm, value: np.float32) -> torch.Tensor:
    """Selector-targeted value overwrite (``__setitem__``'s executor):
    the shard's new values (``value`` already cast to float32 on host)."""
    keep = _shard_selection_keep(loc, row_gather, col_gather, boxes, rm, cm)
    val = torch.tensor(value, device=loc.vals.device)
    return torch.where(keep, val.to(loc.vals.dtype), loc.vals)


def _add_n_prog(locs, sr) -> AssocTensor:
    """⊕ of aligned shards: one shard-local canonical merge of all their
    triples (disjoint aligned row partitions, so zero collectives)."""
    _check_aligned(locs)
    a = locs[0]
    r, c, v, n = dedup_sorted_coo(torch.cat([t.rows for t in locs]),
                                  torch.cat([t.cols for t in locs]),
                                  torch.cat([t.vals for t in locs]),
                                  sr.add, zero=sr.zero)
    return AssocTensor(r, c, v, n, a.row_space, a.col_space, a.val_space)


def _ewise_prog(a: AssocTensor, b: AssocTensor, sr, op: str) -> AssocTensor:
    """Element-wise ⊕ / ⊗ of two aligned shards, shard-local."""
    if op == "add":
        return _add_n_prog([a, b], sr)
    _check_aligned([a, b])
    src = torch.cat([
        torch.zeros(a.capacity, dtype=torch.int32, device=a.device),
        torch.ones(b.capacity, dtype=torch.int32, device=a.device)])
    r, c, v, n = dedup_sorted_coo(
        torch.cat([a.rows, b.rows]), torch.cat([a.cols, b.cols]),
        torch.cat([a.vals, b.vals]), sr.add, zero=sr.zero,
        require_pair=True, pair_op=sr.mul, src=src)
    cap = min(a.capacity, b.capacity)
    return AssocTensor(r[:cap], c[:cap], v[:cap], n.clamp(max=cap),
                       a.row_space, a.col_space, a.val_space)


# ---------------------------------------------------------------------------
# The product's shard programs.  The partial-product exchange and the ring
# shift both move ONE packed int32 array (rows, cols, bitcast values
# stacked on a trailing axis): three separate collectives would triple the
# trip count the contracts pin down.
# ---------------------------------------------------------------------------

def _pack_coo(rows, cols, vals) -> torch.Tensor:
    """Stack COO triples into one int32 tensor (values' float32 bits) — the
    unit a single collective can move."""
    return torch.stack([rows.to(torch.int32), cols.to(torch.int32),
                        vals.to(torch.float32).view(torch.int32)], dim=-1)


def _unpack_coo(packed: torch.Tensor):
    return (packed[..., 0], packed[..., 1],
            packed[..., 2].contiguous().view(torch.float32))


def _finish_coo(r, c, v, nnz, out_cap: int, zero: float) -> dict:
    """Canonical triples cut to ``out_cap``, with the true (pre-cut) nnz
    riding along for the overflow warning."""
    r, c, v = pad_to_cap(r, c, v, out_cap, zero)
    return {"rows": r, "cols": c, "vals": v,
            "nnz": nnz.clamp(max=out_cap).to(torch.int32),
            "true_nnz": nnz}


def _matmul_prog(sr, expand: int, out_cap: int, ar, ac, av, br, bc, bv
                 ) -> dict:
    """Replicate strategy, coo compute: the shard's expand-join against the
    replicated B, then one canonical merge (zero collectives)."""
    pr, pc, pv, _ = expand_join_coo(ar, ac, av, br, bc, bv, sr.mul,
                                    zero=sr.zero, expand=expand)
    r, c, v, nnz = dedup_sorted_coo(pr, pc, pv, sr.add, zero=sr.zero)
    return _finish_coo(r, c, v, nnz, out_cap, sr.zero)


def _matmul_reduce_prog(mesh: Mesh, sr, expand: int, n_out: int, axis: int,
                        ar, ac, av, br, bc, bv) -> torch.Tensor:
    """Replicate strategy, fused reduce: the shard's products ⊕-folded
    straight into a dense ``[n_out]`` partial, then the one combine."""
    pr, pc, pv, _ = expand_join_coo(ar, ac, av, br, bc, bv, sr.mul,
                                    zero=sr.zero, expand=expand)
    keys = pr if axis == 1 else pc
    vec = torch.full((n_out,), sr.zero, dtype=torch.float32, device=ar.device)
    vec = scatter_combine(vec, keys, pv, sr)   # SENT keys drop
    return mesh_combine(vec, mesh, sr)


def _rerank_block(b_rows, bm):
    """A B block's row ranks onto the merged contraction space (``bm`` is
    monotone, so the block stays sorted)."""
    ok = b_rows != SENT
    return torch.where(ok, bm[b_rows.clamp(0, bm.shape[0] - 1).long()], SENT)


@contract(collectives=1, name="dist.matmul_all_to_all",
          note="sharded-B product: one packed all_to_all of partial "
               "products, B never replicated")
def _matmul_a2a_prog(mesh: Mesh, sr, expand: int, bucket_cap: int,
                     out_cap: int, ar, ac, av, br, bc, bv, bm, bounds
                     ) -> dict:
    """Sharded-B all-to-all product.

    ``ar``/``ac``/``av`` are every rank's A triples (gathered); the rank
    expand-joins them against its OWN contraction block of B (``bm``
    reranks the block's rows onto the merged space), buckets the partial
    products by destination row shard over the result's ``bounds``
    (:func:`bucket_coo_by_range`), and exactly one ``all_to_all`` of the
    packed ``[P, bucket_cap, 3]`` buffer delivers every product to the
    rank owning its output row, where one canonical merge ⊕-dedups them.
    """
    pr, pc, pv, _ = expand_join_coo(ar, ac, av, _rerank_block(br, bm), bc,
                                    bv, sr.mul, zero=sr.zero, expand=expand)
    rb, cb, vb = bucket_coo_by_range(pr, pc, pv, bounds, mesh.size,
                                     bucket_cap, zero=sr.zero)
    rows, cols, vals = _unpack_coo(all_to_all(_pack_coo(rb, cb, vb), mesh))
    r, c, v, nnz = dedup_sorted_coo(rows.reshape(-1), cols.reshape(-1),
                                    vals.reshape(-1), sr.add, zero=sr.zero)
    return _finish_coo(r, c, v, nnz, out_cap, sr.zero)


def _ring_peers(rank: int, pc: int) -> Tuple[int, int]:
    """``(dest, src)`` of a rank's ring shift in its group of ``pc``: the
    block goes to the previous rank of the group and comes from the
    next (the JAX ``ppermute`` pairs ``(s, (s // pc)·pc + (s % pc − 1) mod
    pc)``)."""
    g, p = divmod(rank, pc)
    return g * pc + (p - 1) % pc, g * pc + (p + 1) % pc


@contract(collectives=3, name="dist.matmul_2d",
          note="SUMMA-style grid: pc−1 packed ring shifts "
               "(probe grid 1×4 → 3); A never moves")
def _matmul_ring_prog(mesh: Mesh, sr, pr: int, pc: int, round_expand: int,
                      out_cap: int, ar, ac, av, br, bc, bv) -> dict:
    """2D-grid ring product.

    Rank ``s = (g, p)`` (``g = s // pc``) keeps its own A rows and starts
    with B contraction block ``p``; each of the ``pc`` rounds contracts
    the resident block locally, then one ring shift moves the packed block
    within the group (``pc − 1`` shifts in all — the last round skips it).
    Output rows never leave their owner rank, so the round buffers' concat
    and one canonical merge finish the product.
    """
    if pr * pc != mesh.size:
        raise ValueError(f"grid {(pr, pc)} does not tile {mesh.size} ranks")
    dest, src = _ring_peers(mesh.rank, pc)
    bpk = _pack_coo(br, bc, bv)
    parts = []
    for rnd in range(pc):
        b_rows, b_cols, b_vals = _unpack_coo(bpk)
        parts.append(expand_join_coo(ar, ac, av, b_rows, b_cols, b_vals,
                                     sr.mul, zero=sr.zero,
                                     expand=round_expand)[:3])
        if rnd + 1 < pc:
            bpk = ring_shift(bpk, mesh, dest, src)
    r, c, v, nnz = dedup_sorted_coo(torch.cat([p[0] for p in parts]),
                                    torch.cat([p[1] for p in parts]),
                                    torch.cat([p[2] for p in parts]),
                                    sr.add, zero=sr.zero)
    return _finish_coo(r, c, v, nnz, out_cap, sr.zero)


@contract(collectives=1, name="dist.matmul_reduce_all_to_all",
          note="sharded-B fused epilogue: one mesh_combine, no exchange "
               "of partial products needed")
def _matmul_reduce_a2a_prog(mesh: Mesh, sr, expand: int, n_out: int,
                            axis: int, ar, ac, av, br, bc, bv, bm
                            ) -> torch.Tensor:
    """Sharded-B twin of :func:`_matmul_reduce_prog`: the rank folds the
    products of ITS contraction block straight into the dense output
    vector, and the one combine both merges the partials and replaces the
    partial-product exchange."""
    pr, pc, pv, _ = expand_join_coo(ar, ac, av, _rerank_block(br, bm), bc,
                                    bv, sr.mul, zero=sr.zero, expand=expand)
    keys = pr if axis == 1 else pc
    vec = torch.full((n_out,), sr.zero, dtype=torch.float32, device=ar.device)
    vec = scatter_combine(vec, keys, pv, sr)   # SENT keys drop
    return mesh_combine(vec, mesh, sr)


@contract(collectives=0, name="dist.matmul_bsr",
          note="the rank's whole tiled product in one program: its own "
               "pair list against the replicated B")
def _matmul_bsr_prog(sr, plan, a_vals, b_tiles, out_cap: int,
                     kernel_impl: str) -> dict:
    """Replicate strategy, tiled compute: the rank's own pair-list plan
    (``plan``, over its valid A entries and all of B) — its A tiles packed
    here, against the replicated B tiles the caller packed once
    (``b_tiles``, as the JAX program takes them) — contracted by the
    ``bsr_pairlist`` kernel and read out of the present C tiles as
    canonical COO (zero collectives).  Each rank plans and runs only its
    own shard, so no padding to uniform pair-list sizes is needed."""
    r, c, v, true_nnz = bsr_tiles_coo(plan, a_vals, b_tiles, sr, out_cap,
                                      kernel_impl=kernel_impl)
    nnz = torch.tensor(true_nnz, dtype=torch.int64, device=a_vals.device)
    return _finish_coo(r, c, v, nnz, out_cap, sr.zero)


@dataclasses.dataclass
class _MatmulSetup:
    """The product prologue's state on one rank, shared by every strategy.

    ``a_*_h``/``counts`` are this rank's shard on the host (the rank's row
    of the cost model's tables); the ``b_*`` triples are all of B's valid
    entries in the merged contraction rank space, sorted by row, on every
    rank.
    """

    a_loc: AssocTensor             # this rank's shard, logical-coerced
    a_cols: torch.Tensor           # [cap] contraction-space cols
    a_rows_h: np.ndarray
    a_cols_h: np.ndarray
    counts: np.ndarray             # [cap] exact per-entry product counts
    ks: KeySpace                   # merged contraction keyspace
    b_col_space: KeySpace
    b_resident: bool               # B is a DistAssoc on this mesh
    b_other: Optional["DistAssoc"]
    b_map: np.ndarray              # B row rank → merged rank (monotone)
    b_rows_h: np.ndarray           # sorted valid merged contraction ranks
    b_cols_h: np.ndarray
    b_rows: torch.Tensor           # the same on the device, int32
    b_cols: torch.Tensor
    b_vals: torch.Tensor           # float32
    a2a_bounds: Optional[np.ndarray]   # resident B's mapped partition
    bsr_plan: object = None        # this rank's pair-list plan, made once


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

class DistAssoc:
    """Row-partitioned AssocTensor over the ranks of a mesh; this process
    holds shard ``mesh.rank``."""

    # eager metadata default (mirrors AssocTensor.overflow)
    overflow = False

    def __init__(self, local: AssocTensor, mesh: Mesh, *,
                 row_bounds: np.ndarray):
        """``local``: this rank's shard, ``[cap]`` COO on ``mesh.device``.
        ``row_bounds``: shard row-rank boundaries, ``len == size + 1``."""
        self.local = local
        self.mesh = mesh
        self.row_bounds = row_bounds

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_triples(rows, cols, vals, mesh: Mesh, *, aggregate="min",
                     capacity_per_shard: Optional[int] = None,
                     row_space: Optional[KeySpace] = None,
                     col_space: Optional[KeySpace] = None,
                     device="cuda") -> "DistAssoc":
        """Shard raw triples by contiguous row-rank ranges (tablet splits).

        Every rank passes the same triples; each builds the keyspaces (or
        ranks into the given ones), the bounds and the shard capacity — the
        largest shard's count rounded up to 8 — with no collective, and
        keeps only its own shard.  ``device`` must name the mesh's device
        type; the shard lives on ``mesh.device``.
        """
        dev = resolve_device(device)
        if dev.type != mesh.device.type:
            raise ValueError(f"device {dev} does not match the {mesh.backend} "
                             f"mesh on {mesh.device}")
        rows_np, cols_np = np.asarray(rows), np.asarray(cols)
        vals_np = np.asarray(vals)
        if vals_np.ndim == 0:
            vals_np = np.broadcast_to(vals_np, rows_np.shape).copy()
        n_shards = mesh.shape["data"]
        row_space = row_space or KeySpace(rows_np)
        col_space = col_space or KeySpace(cols_np)
        val_space = (KeySpace(vals_np)
                     if vals_np.dtype.kind in ("U", "S", "O") else None)
        r, _ = row_space.rank(rows_np)
        bounds = np.linspace(0, len(row_space), n_shards + 1).astype(np.int64)
        shard_of = np.searchsorted(bounds[1:], r, side="right")
        cap = capacity_per_shard or int(max(8, np.ceil(max(
            np.bincount(shard_of, minlength=n_shards).max(), 1) / 8) * 8))
        m = shard_of == mesh.rank
        local = AssocTensor.from_triples(
            rows_np[m], cols_np[m], vals_np[m], aggregate=aggregate,
            capacity=cap, row_space=row_space, col_space=col_space,
            val_space=val_space, device=mesh.device)
        return DistAssoc(local, mesh, row_bounds=bounds)

    @staticmethod
    def from_assoc(a, mesh: Mesh, *, aggregate="min",
                   capacity_per_shard: Optional[int] = None,
                   device="cuda") -> "DistAssoc":
        """Shard a host Assoc over the mesh (host ⇄ device ⇄ dist)."""
        r, c, v = a.triples()
        return DistAssoc.from_triples(
            r, c, v, mesh, aggregate=aggregate,
            capacity_per_shard=capacity_per_shard, device=device)

    # -- conversions -----------------------------------------------------------
    def to_assoc(self):
        """Every shard gathered into one host Assoc, the same on every rank
        (one ``all_gather``)."""
        return self.gather_replicated().to_assoc()

    def gather_replicated(self) -> AssocTensor:
        """All shards' triples as ONE device AssocTensor on every rank.

        One ``all_gather`` of the packed shard (rows, cols and the values'
        bits), then a compaction: shard row supports are disjoint, ordered
        and individually canonical, so no ⊕-merge runs, and no zero-drop:
        a stored ``0.0`` (legitimate under min/max-family semirings whose
        ⊕-identity is ±inf) survives.
        """
        loc = self.local
        if loc.vals.dtype != torch.float32:
            raise TypeError(f"gather_replicated packs float32 values, got "
                            f"{loc.vals.dtype}")
        g = all_gather(torch.stack([loc.rows, loc.cols,
                                    loc.vals.view(torch.int32)]), self.mesh)
        rows = g[:, 0].reshape(-1)
        cols = g[:, 1].reshape(-1)
        vals = g[:, 2].reshape(-1).view(torch.float32)
        r, c, v, nnz = coo_compact(rows, cols, vals, rows != SENT)
        return AssocTensor(r, c, v, nnz, loc.row_space, loc.col_space,
                           loc.val_space)

    # -- element-wise (alignment-free: row ranges are disjoint) -----------------
    def _ewise(self, other: "DistAssoc", op: str, semiring) -> "DistAssoc":
        out = _ewise_prog(self.local, other.local, get_semiring(semiring), op)
        return DistAssoc(out, self.mesh, row_bounds=self.row_bounds)

    @contract(collectives=0, note="shard-local ⊕: disjoint aligned rows")
    def add(self, other, semiring=PLUS_TIMES):
        """Shard-local ⊕ over disjoint aligned rows (zero collectives)."""
        return self._ewise(other, "add", semiring)

    @contract(collectives=0, note="shard-local ⊗: disjoint aligned rows")
    def mul(self, other, semiring=PLUS_TIMES):
        """Shard-local ⊗ over disjoint aligned rows (zero collectives)."""
        return self._ewise(other, "mul", semiring)

    def __add__(self, other):
        # thin wrapper over the one-node graph (lazy/eager share one path)
        if not isinstance(other, DistAssoc):
            return NotImplemented
        return EwiseAdd(Source(self), Source(other)).collect()

    def __mul__(self, other):
        if not isinstance(other, DistAssoc):
            return NotImplemented
        return EwiseMul(Source(self), Source(other)).collect()

    # -- lazy expressions (the deferred pipeline API, repro_torch.core.expr) ----
    def lazy(self) -> Source:
        """Wrap as a lazy expression Source (see ``Assoc.lazy``)."""
        return Source(self)

    # -- selection (the D4M query surface, sharded) ------------------------------
    def _compiled_selection(self, ij):
        """Compile (row_sel, col_sel) once on host → what every shard runs.

        Shared prologue of ``__getitem__`` and ``__setitem__``: returns
        ``(row_gather, col_gather, boxes, rmask, cmask)`` — the rank-box
        list of ``select.plan_boxes`` (one box for a contiguous selection,
        ≤4 OR-composed boxes for a multi-interval one) and membership masks
        on the rank's device for a scattered axis.  Dispatch mirrors
        ``AssocTensor._selection_keep``.
        """
        from .select import compile_selector, plan_boxes

        loc = self.local
        rc = compile_selector(ij[0], loc.row_space)
        cc = compile_selector(ij[1], loc.col_space)
        nr = max(len(loc.row_space), 1)
        nc = max(len(loc.col_space), 1)
        boxes, row_gather, col_gather = plan_boxes(rc, cc, nr, nc)
        boxes = [tuple(int(x) for x in b) for b in boxes]

        def mask(comp, n, gather):
            if not gather:
                return None
            m = np.ascontiguousarray(np.pad(comp.mask(), (0, n - comp.n)))
            return torch.from_numpy(m).to(self.device)

        if row_gather and col_gather:
            _bump_dispatch("gather")
        elif len(boxes) > 1:
            _bump_dispatch("multirange")
        elif row_gather or col_gather:
            _bump_dispatch("hybrid")
        else:
            _bump_dispatch("range")
        return (row_gather, col_gather, boxes, mask(rc, nr, row_gather),
                mask(cc, nc, col_gather))

    @contract(collectives=0,
              note="selection is shard-local: compiled boxes/masks on "
                   "every rank")
    def __getitem__(self, ij) -> "DistAssoc":
        """Shard-local selection (zero collectives)."""
        i, j = ij
        return Select(Source(self), i, j).collect()

    def _select_eager(self, ij) -> "DistAssoc":
        """D4M selection ``A[row_sel, col_sel]`` on a sharded array.

        The selector compiles **once on host** against the keyspaces —
        every selector form the host ``Assoc`` takes works here — then
        each rank masks and compacts its own triples: both axes contiguous
        → the range-mask kernel; one contiguous axis → the kernel for it
        plus one membership gather; both scattered → two gathers.  Nothing
        densifies.
        """
        out = _select_prog(self.local, *self._compiled_selection(ij))
        return DistAssoc(out, self.mesh, row_bounds=self.row_bounds)

    @contract(collectives=0,
              note="scalar assignment is shard-local over stored entries")
    def __setitem__(self, ij, value) -> None:
        """Selector-targeted scalar assignment, sharded (zero collectives).

        Each rank overwrites the values of its own *stored* entries inside
        the selection; the support is unchanged (inserting new entries is
        a host-side ``from_triples``), as in ``AssocTensor.__setitem__``.
        The scalar is cast to float32.
        """
        if (not isinstance(value, (int, float, np.integer, np.floating))
                or isinstance(value, (bool, np.bool_))):
            raise TypeError("DistAssoc __setitem__ takes a numeric scalar")
        loc = self.local
        if not loc.numeric:
            raise TypeError("DistAssoc __setitem__ requires numeric values")
        vals = _setvals_prog(loc, *self._compiled_selection(ij),
                             np.float32(value))
        self.local = AssocTensor(loc.rows, loc.cols, vals, loc.nnz,
                                 loc.row_space, loc.col_space, loc.val_space)

    # -- global reductions --------------------------------------------------------
    @contract(collectives=1, note="local segment scatter + one mesh_combine")
    def col_reduce(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕ over rows per column → dense ``[n_cols]`` (one collective)."""
        loc = self.local
        return _col_reduce_prog(self.mesh, get_semiring(semiring),
                                len(loc.col_space), loc.cols, loc.vals,
                                loc.rows)

    @contract(collectives=1, note="disjoint-support concat as one collective")
    def row_reduce(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕ over cols per row → dense ``[n_rows]`` (one collective).

        Row supports are disjoint, so the combine is a concatenation of
        shard partials; the column program runs with the rows as keys."""
        loc = self.local
        return _col_reduce_prog(self.mesh, get_semiring(semiring),
                                len(loc.row_space), loc.rows, loc.vals,
                                loc.rows)

    @contract(collectives=1, note="one SUM of per-shard counts")
    def col_degree(self) -> torch.Tensor:
        """Stored entries per column → dense int32 ``[n_cols]`` (one SUM):
        the Graphulo degree-table idiom."""
        loc = self.local
        return _col_degree_prog(self.mesh, len(loc.col_space), loc.cols,
                                loc.rows)

    @contract(collectives=1, note="per-shard y rows + one mesh_combine")
    def matmul_dense_vec(self, x: torch.Tensor,
                         semiring=PLUS_TIMES) -> torch.Tensor:
        """``y = A ⊗.⊕ x`` for a dense vector over the column keyspace, on
        the mesh's device (one collective).

        Every rank produces its own rows of y; the combine is a
        concatenation of disjoint supports.  Accumulates in the promoted
        dtype of the values and ``x``.
        """
        self.mesh.check(x)
        loc = self.local
        sr = get_semiring(semiring)
        dt = torch.promote_types(loc.vals.dtype, x.dtype)
        return _matvec_prog(self.mesh, sr, len(loc.row_space), dt, loc.rows,
                            loc.cols, loc.vals, x)

    # -- array multiplication (Graphulo pushdown, sharded) -----------------------
    def _as_replicated_operand(self, other) -> AssocTensor:
        """The B operand as one device AssocTensor on this rank."""
        from .assoc import Assoc
        if isinstance(other, DistAssoc):
            return other.gather_replicated()
        if isinstance(other, AssocTensor):
            self.mesh.check(other.rows)
            return other
        if isinstance(other, Assoc):
            return other.to_tensor(device=self.device)
        raise TypeError(f"cannot multiply DistAssoc by {type(other)!r}")

    def _matmul_setup(self, other) -> _MatmulSetup:
        """Shared product prologue: logical() strings, align the contraction
        keyspace, rerank this rank's A cols onto it, and bring all of B's
        triples (merged contraction space, sorted by row) to every rank: a
        resident B by one ``all_gather`` of its packed shard, any other B
        as every rank holds it.  Then this rank's exact per-entry product
        counts (two searchsorteds over B's contraction ranks)."""
        a_loc = self.local if self.local.numeric else self.local.logical()
        b_resident = (isinstance(other, DistAssoc)
                      and other.mesh is self.mesh)
        dev = self.device
        if b_resident:
            b_loc = (other.local if other.local.numeric
                     else other.local.logical())
            b_row_space, b_col_space = b_loc.row_space, b_loc.col_space
        else:
            b_t = self._as_replicated_operand(other)
            b_t = b_t if b_t.numeric else b_t.logical()
            b_row_space, b_col_space = b_t.row_space, b_t.col_space
        ks, a_map, b_map = a_loc.col_space.union(b_row_space)
        b_map = np.asarray(b_map, np.int32)

        ok = a_loc.rows != SENT
        cm = _upload_map(a_map, dev)
        a_cols = torch.where(ok, cm[a_loc.cols.clamp(0, cm.shape[0] - 1)
                                    .long()], SENT).to(torch.int32)
        a_rows_h = a_loc.rows.cpu().numpy().astype(np.int64)
        a_cols_h = a_cols.cpu().numpy().astype(np.int64)

        a2a_bounds = None
        if b_resident:
            # shard supports are disjoint and ranges ordered, and the union
            # rank maps are monotone, so ravel order IS sorted order
            g = all_gather(_pack_coo(b_loc.rows, b_loc.cols,
                                     b_loc.vals), self.mesh, prologue=True)
            rows, cols, vals = _unpack_coo(g.reshape(-1, 3))
            keep = rows != SENT
            rh = rows[keep].cpu().numpy()
            b_rows_h = (b_map[rh] if len(b_map) else rh).astype(np.int64)
            b_rows = _upload(b_rows_h, dev, torch.int32)
            b_cols, b_vals = cols[keep], vals[keep]
            rb = np.asarray(other.row_bounds, np.int64)
            if len(b_map):
                a2a_bounds = np.where(
                    rb < len(b_map),
                    b_map.astype(np.int64)[np.clip(rb, 0, len(b_map) - 1)],
                    len(ks))
            else:
                a2a_bounds = np.zeros_like(rb)
        else:
            b_repl = b_t.reranked(ks, b_col_space, b_map,
                                  np.arange(len(b_col_space), dtype=np.int32))
            keep = b_repl.rows != SENT
            b_rows, b_cols = b_repl.rows[keep], b_repl.cols[keep]
            b_vals = b_repl.vals[keep].to(torch.float32)
            b_rows_h = b_rows.cpu().numpy().astype(np.int64)
        b_cols_h = b_cols.cpu().numpy().astype(np.int64)

        b_rows = b_rows.to(torch.int32).contiguous()
        lo = torch.searchsorted(b_rows, a_cols)
        hi = torch.searchsorted(b_rows, a_cols, right=True)
        counts = torch.where(ok, hi - lo, 0).cpu().numpy().astype(np.int64)
        return _MatmulSetup(
            a_loc=a_loc, a_cols=a_cols, a_rows_h=a_rows_h,
            a_cols_h=a_cols_h, counts=counts, ks=ks,
            b_col_space=b_col_space, b_resident=b_resident,
            b_other=other if b_resident else None, b_map=b_map,
            b_rows_h=b_rows_h, b_cols_h=b_cols_h,
            b_rows=b_rows, b_cols=b_cols.to(torch.int32),
            b_vals=b_vals, a2a_bounds=a2a_bounds)

    def _dist_plan(self, st: _MatmulSetup, grid=None):
        """This rank's summary, one ``all_gather`` of every rank's, and the
        same plan on every rank."""
        n_shards = self.mesh.size
        summary = dist_summary(st.a_rows_h, st.a_cols_h, st.counts,
                               len(st.ks), n_shards, grid=grid,
                               a2a_bounds=st.a2a_bounds)
        stacked = all_gather(torch.from_numpy(summary).to(self.device),
                             self.mesh, prologue=True)
        return plan_from_summaries(stacked.cpu().numpy(), st.b_rows_h,
                                   len(st.ks), n_shards,
                                   b_resident=st.b_resident, grid=grid)

    def _a_valid(self, st: _MatmulSetup) -> np.ndarray:
        """Positions of this rank's valid A entries."""
        return np.flatnonzero(st.a_rows_h != int(SENT))

    def _bsr_plan(self, st: _MatmulSetup):
        """This rank's tile-pair plan over its valid A entries and all of
        B (made once per product)."""
        if st.bsr_plan is None:
            idx = self._a_valid(st)
            with _stage("plan", self.device):
                st.bsr_plan = plan_matmul(
                    st.a_rows_h[idx], st.a_cols_h[idx], st.b_rows_h,
                    st.b_cols_h, len(self.local.row_space), len(st.ks),
                    len(st.b_col_space), impl="bsr")
        return st.bsr_plan

    def _gathered_a(self, st: _MatmulSetup):
        """Every rank's A triples (contraction-space cols), flattened in
        rank order: the all-to-all strategies' replicated A (one
        ``all_gather`` of the packed shard)."""
        g = all_gather(_pack_coo(st.a_loc.rows, st.a_cols, st.a_loc.vals),
                       self.mesh, prologue=True)
        return _unpack_coo(g.reshape(-1, 3))

    def _a2a_b_operand(self, st: _MatmulSetup, sr):
        """This rank's contraction block of B and its row rank map for the
        all-to-all programs.  A resident B is reused IN PLACE (its row
        partition is already a contraction partition; the program reranks
        through ``bm``); any other B is sliced by equal contraction ranges
        from the replicated B, the same bounds the cost model's product
        table used (no collective)."""
        dev = self.device
        if st.b_resident:
            loc = st.b_other.local
            return (loc.rows, loc.cols, loc.vals.to(torch.float32),
                    _upload_map(st.b_map, dev))
        k = len(st.ks)
        bnds = np.linspace(0, k, self.mesh.size + 1).astype(np.int64)
        idx = np.searchsorted(st.b_rows_h, bnds)
        r = self.mesh.rank
        rows, cols, vals = self._slice_b(st, int(idx[r]), int(idx[r + 1]),
                                         _cap8(np.diff(idx).max(initial=0)),
                                         sr)
        return rows, cols, vals, torch.arange(max(k, 1), dtype=torch.int32,
                                              device=dev)

    def _slice_b(self, st: _MatmulSetup, lo: int, hi: int, cap: int, sr):
        """B's valid entries ``[lo, hi)``, SENT/zero-padded to ``cap``."""
        return pad_to_cap(st.b_rows[lo:hi], st.b_cols[lo:hi],
                          st.b_vals[lo:hi], cap, sr.zero)

    def _stage_b_blocks(self, st: _MatmulSetup, sr, pr: int, pc: int,
                        block_cap: int):
        """This rank's B contraction block for the 2D grid: rank ``(g, p)``
        holds block ``p`` (``pr``-fold replication — the cost model's
        ``pr·nnz(B)`` term), padded to the uniform ``block_cap`` so whole
        blocks ring-shift as one packed array."""
        bnds = np.linspace(0, len(st.ks), pc + 1).astype(np.int64)
        idx = np.searchsorted(st.b_rows_h, bnds)
        blk = self.mesh.rank % pc
        return self._slice_b(st, int(idx[blk]), int(idx[blk + 1]), block_cap,
                             sr)

    def _estimated_out_cap(self, st: _MatmulSetup, plan) -> int:
        """Per-shard output capacity, the same on every rank.

        The replicate expand size (total products of the worst shard) is a
        correct but hub-pessimal bound; past 4096 each rank runs
        :func:`repro_torch.core.spgemm.estimate_out_nnz` over its own
        shard's blocks and one ``all_reduce`` MAX gives the largest — the
        sketch can in principle under-estimate, so the overflow
        ``RuntimeWarning`` stays the safety net.
        """
        expand = plan.expands["replicate"]
        if expand <= _OUT_CAP_ESTIMATE:
            return expand
        best = 0
        if len(self._a_valid(st)):
            p = self._bsr_plan(st)
            with _stage("estimate_out_nnz", self.device):
                best = estimate_out_nnz(p)
        best = all_reduce(torch.tensor([best], dtype=torch.int64,
                                       device=self.device), self.mesh, "max",
                          prologue=True)
        return min(expand, _cap8(best[0]))

    def _matmul_finish(self, out: dict, st: _MatmulSetup,
                       out_cap: int) -> "DistAssoc":
        """Shared epilogue: overflow surfacing + result assembly (row
        partition unchanged — every strategy emits row-sharded output)."""
        true_nnz = int(out["true_nnz"])
        mine = true_nnz > out_cap
        flag = all_reduce(torch.tensor([int(mine)], dtype=torch.int32,
                                       device=self.device), self.mesh, "max",
                          prologue=True)
        overflowed = bool(flag[0])
        if mine:
            warnings.warn(
                f"DistAssoc.matmul: shard {self.mesh.rank} produced "
                f"{true_nnz} entries but out_capacity_per_shard is "
                f"{out_cap}; excess entries were dropped — pass a larger "
                f"out_capacity_per_shard", RuntimeWarning, stacklevel=3)
        new_local = AssocTensor(out["rows"].to(torch.int32),
                                out["cols"].to(torch.int32), out["vals"],
                                out["nnz"], self.local.row_space,
                                st.b_col_space, None)
        result = DistAssoc(new_local, self.mesh, row_bounds=self.row_bounds)
        result.overflow = overflowed
        return result

    @contract(collectives=0,
              note="replicate strategy: shard-local product, zero program "
                   "collectives; sharded-B strategies carry their own "
                   "contracts (dist.matmul_all_to_all / dist.matmul_2d)")
    def matmul(self, other, semiring=PLUS_TIMES, *, impl: str = "auto_dist",
               kernel_impl: str = "auto",
               grid: Optional[Tuple[int, int]] = None,
               out_capacity_per_shard: Optional[int] = None) -> "DistAssoc":
        """Array multiplication ``A ⊗.⊕ B``, communication-strategy-tuned.

        ``other`` may be an ``AssocTensor`` or host ``Assoc`` (the same on
        every rank) or another ``DistAssoc`` (a resident B on this mesh is
        reused in place on the sharded paths).  ``impl`` picks the
        communication strategy:

        ``"auto_dist"`` (default)
            the host cost model chooses per multiply from exact product
            counts; the choice lands in ``PLAN_STATS["dist_replicate"/
            "dist_all_to_all"/"dist_2d"]``.
        ``"replicate"``
            B on every rank, shard-local product, zero program
            collectives (the Graphulo tablet-server pattern).
        ``"all_to_all"``
            B sharded by contraction range; one packed ``all_to_all`` of
            partial products.
        ``"2d"``
            ``(pr, pc)`` grid (``grid=`` forces it), ``pc − 1`` ring
            shifts of B blocks; A never moves.
        ``"auto"`` / ``"coo"`` / ``"bsr"`` (legacy spelling)
            replicate strategy with that shard-local compute: ``coo`` the
            expand-join, ``bsr`` the tiled pair list through the
            ``bsr_pairlist`` kernel (``kernel_impl`` — ``"auto"``,
            ``"cuda"`` or ``"ref"`` — forwards to its dispatch), ``auto``
            the :data:`~repro_torch.core.spgemm.BSR_AUTO_EXPAND`
            crossover.

        ``out_capacity_per_shard`` sizes every shard's result; by default
        it is the replicate expand size, or past 4096 the largest shard's
        estimated output.
        """
        if impl not in _MATMUL_IMPLS:
            raise ValueError(
                f"unknown DistAssoc matmul impl {impl!r}; expected "
                f"auto_dist/replicate/all_to_all/2d or legacy auto/coo/bsr")
        if kernel_impl not in _KERNEL_IMPLS:
            raise ValueError(f"unknown kernel_impl {kernel_impl!r}; expected "
                             f"auto/cuda/ref")
        if grid is not None and grid[0] * grid[1] != self.mesh.size:
            raise ValueError(f"grid {grid} does not tile {self.mesh.size} "
                             f"shards")
        sr = get_semiring(semiring)
        dev = self.device
        with _stage("setup", dev):
            st = self._matmul_setup(other)
        with _stage("dist_plan", dev):
            plan = self._dist_plan(st, grid)
        if impl == "auto_dist":
            strategy, local = plan.strategy, "auto"
        elif impl in ("replicate", "all_to_all", "2d"):
            strategy, local = impl, "auto"
        else:  # legacy spellings pin the replicate strategy's local compute
            strategy, local = "replicate", impl
        from .plan import _bump  # lazy: plan.py imports this module
        _bump(f"dist_{strategy}")
        out_cap = out_capacity_per_shard or self._estimated_out_cap(st, plan)

        a = (st.a_loc.rows, st.a_cols, st.a_loc.vals.to(torch.float32))
        if strategy == "all_to_all":
            b_op = self._a2a_b_operand(st, sr)
            out = _matmul_a2a_prog(
                self.mesh, sr, plan.expands["all_to_all"], plan.bucket_cap,
                out_cap, *self._gathered_a(st), *b_op,
                _upload(self.row_bounds, dev, torch.int64))
            return self._matmul_finish(out, st, out_cap)
        if strategy == "2d":
            pr, pc = plan.grid
            b_blk = self._stage_b_blocks(st, sr, pr, pc, plan.block_cap)
            out = _matmul_ring_prog(self.mesh, sr, pr, pc, plan.expands["2d"],
                                    out_cap, *a, *b_blk)
            return self._matmul_finish(out, st, out_cap)

        # replicate strategy: the coo program or the tiled pair-list program
        expand = plan.expands["replicate"]
        if local == "bsr" or (local == "auto" and expand >= BSR_AUTO_EXPAND):
            idx = self._a_valid(st)
            a_vals = st.a_loc.vals[_upload(idx, dev)].to(torch.float32)
            tile_plan = self._bsr_plan(st)
            with _stage("pack_tiles", dev):
                b_tiles = pack_b_tiles(tile_plan, st.b_vals, sr)
            out = _matmul_bsr_prog(sr, tile_plan, a_vals, b_tiles, out_cap,
                                   kernel_impl)
            return self._matmul_finish(out, st, out_cap)
        out = _matmul_prog(sr, expand, out_cap, *a, st.b_rows, st.b_cols,
                           st.b_vals)
        return self._matmul_finish(out, st, out_cap)

    def __matmul__(self, other):
        # thin wrapper over the one-node graph (see __add__)
        if isinstance(other, (DistAssoc, AssocTensor)) or hasattr(other, "adj"):
            return MatMul(Source(self), Source(other)).collect()
        return NotImplemented

    @contract(collectives=1, note="fused epilogue: exactly one reduction")
    def matmul_reduce(self, other, axis: int = 1, semiring=PLUS_TIMES, *,
                      impl: str = "auto_dist") -> torch.Tensor:
        """Fused ``⊕-reduce(A ⊗.⊕ B, axis)`` — one program collective, no C.

        Each rank ⊕-folds products straight into a dense vector (no merge,
        no sort — ⊕ over every product per row/col IS the answer) and the
        partials combine with exactly one ``all_reduce``.  ``axis=1`` → a
        vector over the row keyspace; ``axis=0`` → over B's col keyspace.

        ``impl``: ``"replicate"`` (B on every rank, each rank folds its own
        rows' products), ``"all_to_all"`` (B sharded by contraction range:
        each rank folds the products of ITS block, and the same combine
        replaces the partial-product exchange) or ``"auto_dist"``, which
        takes ``all_to_all`` only on more than one rank and when its
        modeled cost is lower.
        """
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0 or 1, got {axis!r}")
        if impl not in ("auto_dist", "replicate", "all_to_all"):
            raise ValueError(
                f"unknown matmul_reduce impl {impl!r}; expected "
                f"auto_dist/replicate/all_to_all")
        sr = get_semiring(semiring)
        st = self._matmul_setup(other)
        plan = self._dist_plan(st)
        if impl == "auto_dist":
            strategy = ("all_to_all"
                        if self.mesh.size > 1 and (plan.costs["all_to_all"]
                                                   < plan.costs["replicate"])
                        else "replicate")
        else:
            strategy = impl
        from .plan import _bump  # lazy: plan.py imports this module
        _bump(f"dist_{strategy}")
        n_out = (len(self.local.row_space) if axis == 1
                 else len(st.b_col_space))
        if strategy == "all_to_all":
            return _matmul_reduce_a2a_prog(
                self.mesh, sr, plan.expands["all_to_all"], n_out, axis,
                *self._gathered_a(st), *self._a2a_b_operand(st, sr))
        return _matmul_reduce_prog(
            self.mesh, sr, plan.expands["replicate"], n_out, axis,
            st.a_loc.rows, st.a_cols, st.a_loc.vals.to(torch.float32),
            st.b_rows, st.b_cols, st.b_vals)

    @contract(collectives=1, note="fused reduce= epilogue (AA^T)")
    def sqout(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AAᵀ — the row-key graph, sharded like A; ``reduce=0/1`` runs the
        fused epilogue instead (a dense vector, one combine).  Aᵀ is
        gathered to every rank (one ``all_gather``)."""
        t = self.gather_replicated().transpose()
        if reduce is None:
            return self.matmul(t, semiring)
        return self.matmul_reduce(t, reduce, semiring)

    @contract(collectives=1, note="fused reduce= epilogue (A^T A)")
    def sqin(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AᵀA — the correlation idiom.  The transpose breaks the row
        partition, so this runs as gathered Aᵀ × gathered A on the device
        layer of every rank (one ``all_gather``): a replicated
        ``AssocTensor``, or with ``reduce=0/1`` the fused vector."""
        me = self.gather_replicated()
        t = me.transpose()
        if reduce is None:
            return t.matmul(me, semiring)
        return t.matmul_reduce(me, reduce, semiring)
