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

The shard programs below are plain functions of one rank's tensors, named
after the JAX package's ``shard_map`` programs.  The array product (the
replicate, all-to-all and 2-D strategies) is ROADMAP module step 6b and
raises ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .assoc_tensor import (AssocTensor, _bump_dispatch, coo_axis_mask_keep,
                           coo_compact, coo_mask_keep, coo_range_keep,
                           resolve_device)
from .collectives import all_gather, mesh_combine
from .coo import SENT, dedup_sorted_coo
from .expr import EwiseAdd, EwiseMul, Select, Source
from .keyspace import KeySpace
from .mesh import Mesh
from .semiring import PLUS_TIMES, get_semiring, scatter_combine

__all__ = ["DistAssoc"]

_STEP_6B = ("DistAssoc products (matmul, matmul_reduce, sqout, sqin, @) "
            "are not ported yet: they come with ROADMAP module step 6b")


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
                  boxes, rm, cm, value: float) -> torch.Tensor:
    """Selector-targeted value overwrite (``__setitem__``'s executor):
    the shard's new values."""
    keep = _shard_selection_keep(loc, row_gather, col_gather, boxes, rm, cm)
    val = torch.tensor(np.float32(value), device=loc.vals.device)
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

    def add(self, other, semiring=PLUS_TIMES):
        """Shard-local ⊕ over disjoint aligned rows (zero collectives)."""
        return self._ewise(other, "add", semiring)

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
        vals = _setvals_prog(loc, *self._compiled_selection(ij), value)
        self.local = AssocTensor(loc.rows, loc.cols, vals, loc.nnz,
                                 loc.row_space, loc.col_space, loc.val_space)

    # -- global reductions --------------------------------------------------------
    def col_reduce(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕ over rows per column → dense ``[n_cols]`` (one collective)."""
        loc = self.local
        return _col_reduce_prog(self.mesh, get_semiring(semiring),
                                len(loc.col_space), loc.cols, loc.vals,
                                loc.rows)

    def row_reduce(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕ over cols per row → dense ``[n_rows]`` (one collective).

        Row supports are disjoint, so the combine is a concatenation of
        shard partials; the column program runs with the rows as keys."""
        loc = self.local
        return _col_reduce_prog(self.mesh, get_semiring(semiring),
                                len(loc.row_space), loc.rows, loc.vals,
                                loc.rows)

    def col_degree(self) -> torch.Tensor:
        """Stored entries per column → dense int32 ``[n_cols]`` (one SUM):
        the Graphulo degree-table idiom."""
        loc = self.local
        return _col_degree_prog(self.mesh, len(loc.col_space), loc.cols,
                                loc.rows)

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

    # -- array multiplication: module step 6b ------------------------------------
    def matmul(self, other, semiring=PLUS_TIMES, **kw):
        raise NotImplementedError(_STEP_6B)

    def matmul_reduce(self, other, axis: int = 1, semiring=PLUS_TIMES, **kw):
        raise NotImplementedError(_STEP_6B)

    def sqout(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        raise NotImplementedError(_STEP_6B)

    def sqin(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        raise NotImplementedError(_STEP_6B)

    def __matmul__(self, other):
        raise NotImplementedError(_STEP_6B)
