"""Device associative arrays: fixed-capacity, semiring-generic, on torch.

``AssocTensor`` is the device counterpart of the host ``Assoc``.  Where the
paper's Python implementation leans on ``scipy.sparse`` with dynamic shapes,
the device layer keeps static shapes and bulk tensor ops:

* keys are **int32 ranks** into host-side :class:`~repro_torch.core.keyspace.KeySpace`
  dictionaries (see that module for why rank order ⇔ key order);
* the nonempty entries live in a **sorted, sentinel-padded COO triple**
  ``(rows, cols, vals)`` of static ``capacity`` plus an ``nnz`` 0-dim
  tensor — growth is an explicit host-side rebuild, mirroring how
  Accumulo-backed D4M splits tablets rather than reallocating per insert;
* element-wise algebra is *concat → stable sort → segment-reduce* — one
  shape-static pipeline that subsumes the paper's constructor aggregation,
  sorted-union addition and sorted-intersection multiplication;
* array multiplication is planned on host and runs through the hand-written
  CUDA kernels (:mod:`repro_torch.core.spgemm`).

The tensors live on one ``device``.  Constructors take ``device=`` and
default to ``"cuda"``; with no CUDA they raise rather than build on the
CPU, so a CPU array is always one the caller asked for.  The only in-place
operation is ``__setitem__`` (see its docstring).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import contract

from .assoc import Assoc
from .coo import SENT, compact_to_front, dedup_sorted_coo, sort_key
from .expr import EwiseAdd, EwiseMul, MatMul, Select, Source
from .keyspace import KeySpace
from .semiring import PLUS_TIMES, get_semiring
from .sorted_ops import INT_SENTINEL

__all__ = ["AssocTensor", "dedup_sorted_coo", "resolve_device"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device) -> torch.device:
    """The device an entry point builds on; ``"cuda"`` without a card raises
    (no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to build on the host")
    return dev


# -- selection primitives on raw COO rank tensors ------------------------------

def coo_range_keep(rows: torch.Tensor, cols: torch.Tensor,
                   bounds) -> torch.Tensor:
    """Keep mask for a rank box — the range-mask kernel on CUDA tensors."""
    from repro_torch.kernels.range_extract import range_mask
    return range_mask(rows, cols, bounds) != 0


def coo_mask_keep(rows: torch.Tensor, cols: torch.Tensor,
                  row_mask: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """Keep mask for keyspace membership masks (one gather each)."""
    ok = rows != SENT
    return (ok & row_mask[rows.clamp(0, row_mask.shape[0] - 1).long()]
            & col_mask[cols.clamp(0, col_mask.shape[0] - 1).long()])


def coo_axis_mask_keep(idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Single-axis membership gather (the set half of a hybrid selection)."""
    ok = idx != SENT
    return ok & mask[idx.clamp(0, mask.shape[0] - 1).long()]


# Selection-path dispatch counters (eager queries only): which execution
# path compiled selections take — ``range`` (range-mask kernel, both axes
# contiguous), ``multirange`` (a multi-interval selection decomposed into
# ≤4 range-kernel boxes, OR-composed), ``hybrid`` (one contiguous axis
# through the range kernel + one membership gather), ``gather`` (both axes
# scattered).  Tests and benchmarks read these to pin the fast path.
DISPATCH_STATS = {"range": 0, "multirange": 0, "hybrid": 0, "gather": 0}

# Dict += is a read-modify-write: concurrent callers bump these.
_DISPATCH_LOCK = threading.Lock()


def _bump_dispatch(key: str) -> None:
    with _DISPATCH_LOCK:
        DISPATCH_STATS[key] += 1


def coo_compact(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                keep: torch.Tensor):
    """Keep-masked canonical triples → canonical sorted/sentinel-padded form.

    The kept entries of a canonical COO are already in (row, col) order, so
    a stable compaction to the front is the whole canonicalization.
    """
    r, c, v = compact_to_front(keep, (rows, SENT), (cols, SENT), (vals, 0.0))
    return r, c, v, keep.sum().to(torch.int32)


@dataclasses.dataclass
class AssocTensor:
    """Device associative array (padded COO + host keyspaces)."""

    rows: torch.Tensor  # int32[capacity], sorted by (row, col), SENT-padded
    cols: torch.Tensor  # int32[capacity]
    vals: torch.Tensor  # float32[capacity] (value-ranks + 1 if val_space)
    nnz: torch.Tensor   # int32 0-dim
    row_space: KeySpace
    col_space: KeySpace
    val_space: Optional[KeySpace] = None  # None ⇒ numeric values

    # capacity-producing ops (matmul, from_dense_adj) set an instance
    # attribute when the result was truncated
    overflow = False

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_triples(row_keys, col_keys, values, *, aggregate="min",
                     capacity: Optional[int] = None,
                     row_space: Optional[KeySpace] = None,
                     col_space: Optional[KeySpace] = None,
                     val_space: Optional[KeySpace] = None,
                     device="cuda") -> "AssocTensor":
        """Host-side constructor (the D4M ``Assoc(row, col, val)`` analogue).

        Builds keyspaces (or ranks into provided ones), uploads rank triples
        to ``device``, and canonicalizes there with the ``aggregate``
        collision op.  ``val_space`` is used for string values only.
        """
        dev = resolve_device(device)
        row_keys = np.asarray(row_keys)
        col_keys = np.asarray(col_keys)
        values = np.asarray(values)
        if values.ndim == 0:
            values = np.broadcast_to(values, row_keys.shape).copy()

        if values.dtype.kind in ("U", "S", "O"):
            val_space = val_space or KeySpace(values)
            vals_num, _ = val_space.rank(values)
            vals_num = vals_num.astype(np.float32)
        else:
            val_space = None
            vals_num = values.astype(np.float32)

        row_space = row_space or KeySpace(row_keys)
        col_space = col_space or KeySpace(col_keys)
        r, _ = row_space.rank(row_keys)
        c, _ = col_space.rank(col_keys)

        cap = capacity or _round_up(max(len(r), 8), 8)
        if cap < len(r):
            raise ValueError(f"capacity {cap} < {len(r)} triples")
        pad = cap - len(r)
        rj = torch.from_numpy(np.concatenate(
            [r, np.full(pad, INT_SENTINEL, np.int32)])).to(dev)
        cj = torch.from_numpy(np.concatenate(
            [c, np.full(pad, INT_SENTINEL, np.int32)])).to(dev)
        vj = torch.from_numpy(np.concatenate(
            [vals_num, np.zeros(pad, np.float32)])).to(dev)

        agg = {
            "min": torch.minimum, "max": torch.maximum, "sum": torch.add,
            min: torch.minimum, max: torch.maximum, sum: torch.add,
        }.get(aggregate, aggregate)
        # string values: aggregation acts on ranks; offset by +1 so that the
        # zero-drop below only removes true sentinels, not rank 0.
        if val_space is not None:
            vj = torch.where(rj != SENT, vj + 1.0, 0.0)
        rows, cols, vals, nnz = dedup_sorted_coo(rj, cj, vj, agg)
        return AssocTensor(rows, cols, vals, nnz, row_space, col_space, val_space)

    @staticmethod
    def from_assoc(a: Assoc, capacity: Optional[int] = None, *,
                   row_space: Optional[KeySpace] = None,
                   col_space: Optional[KeySpace] = None,
                   device="cuda") -> "AssocTensor":
        """Upload a host Assoc; inverse of :meth:`to_assoc` (lossless for
        string values and f32-representable numeric values; explicit 0.0
        entries are dropped — the device stores 0 as empty)."""
        r, c, v = a.triples()
        return AssocTensor.from_triples(r, c, v, capacity=capacity,
                                        row_space=row_space,
                                        col_space=col_space, device=device)

    def to_assoc(self) -> Assoc:
        """Download to the host paper-faithful representation."""
        n = int(self.nnz)
        r = self.rows[:n].cpu().numpy()
        c = self.cols[:n].cpu().numpy()
        v = self.vals[:n].cpu().numpy()
        row_keys = self.row_space.keys[r]
        col_keys = self.col_space.keys[c]
        if self.val_space is not None:
            vals = self.val_space.keys[(v - 1.0).astype(np.int64)]
        else:
            vals = v.astype(np.float64)
        return Assoc(row_keys, col_keys, vals)

    # -- basic properties -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def numeric(self) -> bool:
        return self.val_space is None

    def valid_mask(self) -> torch.Tensor:
        return self.rows != SENT

    # -- re-ranking onto merged keyspaces --------------------------------------
    def reranked(self, row_space: KeySpace, col_space: KeySpace,
                 row_map: np.ndarray, col_map: np.ndarray) -> "AssocTensor":
        """Translate ranks onto merged keyspaces (one gather each)."""
        rm = _upload_map(row_map, self.device)
        cm = _upload_map(col_map, self.device)
        ok = self.valid_mask()
        rows = torch.where(ok, rm[self.rows.clamp(0, len(rm) - 1).long()], SENT)
        cols = torch.where(ok, cm[self.cols.clamp(0, len(cm) - 1).long()], SENT)
        return AssocTensor(rows, cols, self.vals, self.nnz,
                           row_space, col_space, self.val_space)

    def _aligned(self, other: "AssocTensor"):
        """Bring two arrays onto common keyspaces (host merge, amortized)."""
        rs, rm_a, rm_b = self.row_space.union(other.row_space)
        cs, cm_a, cm_b = self.col_space.union(other.col_space)
        a = self if (rs == self.row_space and cs == self.col_space) else \
            self.reranked(rs, cs, rm_a, cm_a)
        b = other if (rs == other.row_space and cs == other.col_space) else \
            other.reranked(rs, cs, rm_b, cm_b)
        return a, b

    # -- lazy expressions (the deferred pipeline API, repro_torch.core.expr) ---
    def lazy(self) -> Source:
        """Wrap as a lazy expression Source (see ``Assoc.lazy``)."""
        return Source(self)

    # -- element-wise algebra ---------------------------------------------------
    def add(self, other: "AssocTensor", semiring=PLUS_TIMES) -> "AssocTensor":
        """Element-wise ⊕ over the union of key sets (paper §II.C.1)."""
        sr = get_semiring(semiring)
        a, b = self._aligned(other)
        rows = torch.cat([a.rows, b.rows])
        cols = torch.cat([a.cols, b.cols])
        vals = torch.cat([a.vals, b.vals])
        r, c, v, nnz = dedup_sorted_coo(rows, cols, vals, sr.add, zero=sr.zero)
        return AssocTensor(r, c, v, nnz, a.row_space, a.col_space, a.val_space)

    def __add__(self, other):
        # thin wrapper over the one-node graph (lazy/eager share one path);
        # expression operands defer to the Node's reflected operator
        if not isinstance(other, AssocTensor):
            return NotImplemented
        return EwiseAdd(Source(self), Source(other)).collect()

    def mul(self, other: "AssocTensor", semiring=PLUS_TIMES) -> "AssocTensor":
        """Element-wise ⊗ over the intersection of key sets (paper §II.C.2)."""
        sr = get_semiring(semiring)
        a, b = self._aligned(other)
        rows = torch.cat([a.rows, b.rows])
        cols = torch.cat([a.cols, b.cols])
        vals = torch.cat([a.vals, b.vals])
        src = torch.cat([
            torch.zeros(a.capacity, dtype=torch.int32, device=a.device),
            torch.ones(b.capacity, dtype=torch.int32, device=a.device)])
        r, c, v, nnz = dedup_sorted_coo(
            rows, cols, vals, sr.add, zero=sr.zero,
            require_pair=True, pair_op=sr.mul, src=src)
        cap = min(a.capacity, b.capacity)
        return AssocTensor(r[:cap], c[:cap], v[:cap], nnz.clamp(max=cap),
                           a.row_space, a.col_space, a.val_space)

    def __mul__(self, other):
        if not isinstance(other, AssocTensor):
            return NotImplemented
        return EwiseMul(Source(self), Source(other)).collect()

    def logical(self) -> "AssocTensor":
        """Replace nonempty entries with 1 (paper's ``.logical()``)."""
        ok = self.valid_mask()
        return AssocTensor(self.rows, self.cols,
                           torch.where(ok, 1.0, 0.0).to(self.vals.dtype),
                           self.nnz, self.row_space, self.col_space, None)

    # -- densification + array multiplication -----------------------------------
    def to_dense_adj(self, *, pad_to: int = 128,
                     zero: float = 0.0) -> torch.Tensor:
        """Scatter onto a dense (|rowspace|, |colspace|) tile-aligned array."""
        nr = _round_up(max(len(self.row_space), 1), pad_to)
        nc = _round_up(max(len(self.col_space), 1), pad_to)
        ok = self.valid_mask()
        # padding entries land in one spare slot that is cut off
        flat_idx = torch.where(ok, self.rows.long() * nc + self.cols.long(),
                               nr * nc)
        dense = torch.full((nr * nc + 1,), zero, dtype=self.vals.dtype,
                           device=self.device)
        # duplicate-free by invariant: plain scatter
        dense[flat_idx] = torch.where(ok, self.vals, zero).to(self.vals.dtype)
        return dense[:nr * nc].view(nr, nc)

    @staticmethod
    def from_dense_adj(dense, row_space: KeySpace, col_space: KeySpace,
                       capacity: int, *, zero: float = 0.0,
                       warn_overflow: bool = True) -> "AssocTensor":
        """Top-|capacity| nonzeros of a dense adj back to padded COO.

        When the true nonzero count exceeds ``capacity`` the excess entries
        (latest in (row, col) order) are dropped; the result records that
        as an ``overflow`` attribute (bool) and emits a ``RuntimeWarning``
        — a silent truncation here corrupts every downstream ⊕ without a
        trace.
        """
        nr, nc = dense.shape
        flat = dense.reshape(-1)
        ok = flat != zero
        # order: valid entries first, in row-major (row, col) order — a
        # stable sort, because which entries survive truncation is part of
        # the result
        idx = torch.arange(flat.shape[0], dtype=torch.int64,
                           device=dense.device)
        order = torch.sort(torch.where(ok, idx, 2 ** 31 - 1),
                           stable=True).indices[:capacity]
        taken_ok = ok[order]
        rows = torch.where(taken_ok, order // nc, SENT).to(torch.int32)
        cols = torch.where(taken_ok, order % nc, SENT).to(torch.int32)
        vals = torch.where(taken_ok, flat[order],
                           torch.tensor(zero, dtype=flat.dtype,
                                        device=flat.device))
        true_nnz = int(ok.sum())
        nnz = torch.tensor(min(true_nnz, capacity), dtype=torch.int32,
                           device=dense.device)
        out = AssocTensor(rows, cols, vals, nnz, row_space, col_space, None)
        out.overflow = true_nnz > capacity
        if warn_overflow and out.overflow:
            import warnings
            warnings.warn(
                f"from_dense_adj: {true_nnz} nonzeros exceed capacity "
                f"{capacity}; {true_nnz - capacity} entries dropped",
                RuntimeWarning, stacklevel=2)
        return out

    def transpose(self) -> "AssocTensor":
        """Swap rows/cols and restore canonical (row, col) order."""
        ok = self.valid_mask()
        r = torch.where(ok, self.cols, SENT)
        c = torch.where(ok, self.rows, SENT)
        order = torch.sort(sort_key(r, c), stable=True).indices
        return AssocTensor(r[order], c[order], self.vals[order], self.nnz,
                           self.col_space, self.row_space, self.val_space)

    @property
    def T(self) -> "AssocTensor":
        return self.transpose()

    def matmul(self, other: "AssocTensor", semiring=PLUS_TIMES,
               out_capacity: Optional[int] = None,
               use_kernel: bool = True, impl: str = "auto",
               kernel_impl: str = "auto") -> "AssocTensor":
        """Array multiplication ``⊗.⊕`` contracting over col/row keys.

        Strings are first reduced via ``logical()`` (paper rule).  Planned
        and executed by :mod:`repro_torch.core.spgemm` — the dense strategy
        contracts tile-aligned adjacencies through the semiring-matmul
        kernel; the BSR strategy packs only the present 128×128 tiles and
        runs the pair-list kernel, never materializing the dense product;
        ``impl`` overrides the auto heuristic (``"dense"`` / ``"bsr"`` /
        ``"coo"``) and ``kernel_impl`` the kernel dispatch (``"cuda"`` /
        ``"ref"`` / ``"auto"``, which follows the tensors' device).
        """
        from .spgemm import matmul as _planned_matmul
        return _planned_matmul(self, other, semiring, impl=impl,
                               out_capacity=out_capacity,
                               use_kernel=use_kernel,
                               kernel_impl=kernel_impl)

    def matmul_reduce(self, other: "AssocTensor", axis: int,
                      semiring=PLUS_TIMES, *, impl: str = "auto",
                      kernel_impl: str = "auto") -> torch.Tensor:
        """Fused ``⊕-reduce(self ⊗.⊕ other, axis)`` — skips materializing
        the product entirely (Graphulo pushdown; see
        :func:`repro_torch.core.spgemm.matmul_reduce`).  Returns a dense
        vector over ``self.row_space`` (``axis=1``) or ``other.col_space``
        (``axis=0``)."""
        from .spgemm import matmul_reduce as _planned_reduce
        return _planned_reduce(self, other, axis, semiring, impl=impl,
                               kernel_impl=kernel_impl)

    def sqin(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AᵀA — the correlation idiom.  ``reduce=0/1`` returns the fused
        ⊕-reduction of the square instead (vector over the col keyspace)."""
        t = self.transpose()
        if reduce is None:
            return t.matmul(self, semiring)
        return t.matmul_reduce(self, reduce, semiring)

    def sqout(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AAᵀ — row-key graph; ``reduce=0/1`` for the fused reduction."""
        t = self.transpose()
        if reduce is None:
            return self.matmul(t, semiring)
        return self.matmul_reduce(t, reduce, semiring)

    def __matmul__(self, other):
        if not isinstance(other, AssocTensor):
            return NotImplemented
        return MatMul(Source(self), Source(other)).collect()

    # -- extraction -------------------------------------------------------------
    #
    # All __getitem__ selection routes through the selector algebra
    # (repro_torch.core.select): the selector compiles once on host against
    # the keyspaces, then executes on device against the padded COO triples
    # — a contiguous rank box goes through the range-mask kernel, a general
    # index set through one membership gather.  Selection never densifies.

    def _compact(self, keep: torch.Tensor) -> "AssocTensor":
        """Keep-masked triples → canonical sorted/sentinel-padded form."""
        r, c, v, nnz = coo_compact(self.rows, self.cols, self.vals, keep)
        return AssocTensor(r, c, v, nnz,
                           self.row_space, self.col_space, self.val_space)

    def _range_keep(self, row_range: Tuple[int, int],
                    col_range: Tuple[int, int]) -> torch.Tensor:
        """Keep mask for a rank box, via the range-mask kernel."""
        bounds = (int(row_range[0]), int(row_range[1]),
                  int(col_range[0]), int(col_range[1]))
        return coo_range_keep(self.rows, self.cols, bounds)

    def _mask_keep(self, row_mask: torch.Tensor,
                   col_mask: torch.Tensor) -> torch.Tensor:
        """Keep mask for keyspace membership masks (one gather each)."""
        return coo_mask_keep(self.rows, self.cols, row_mask, col_mask)

    def extract_ranges(self, row_range: Tuple[int, int],
                       col_range: Tuple[int, int]) -> "AssocTensor":
        """Sub-array by rank ranges (host resolves key slices → ranks)."""
        return self._compact(self._range_keep(row_range, col_range))

    def extract_mask(self, row_mask: torch.Tensor,
                     col_mask: torch.Tensor) -> "AssocTensor":
        """Sub-array by keyspace membership masks (gather path).

        ``row_mask``/``col_mask`` are bool tensors over the row/col
        keyspaces — the compiled form of a non-contiguous selector.
        """
        return self._compact(self._mask_keep(row_mask.to(self.device),
                                             col_mask.to(self.device)))

    def _compiled_pair(self, ij):
        from .select import compile_selector
        return (compile_selector(ij[0], self.row_space),
                compile_selector(ij[1], self.col_space))

    def _upload_mask(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)

    def _device_masks(self, rc, cc) -> Tuple[torch.Tensor, torch.Tensor]:
        rm = rc.mask() if len(self.row_space) else np.zeros(1, bool)
        cm = cc.mask() if len(self.col_space) else np.zeros(1, bool)
        return self._upload_mask(rm), self._upload_mask(cm)

    def _selection_keep(self, ij) -> torch.Tensor:
        """Compile (row_sel, col_sel) and evaluate the device keep mask.

        The single dispatch point between four execution paths — both
        ``__getitem__`` and ``__setitem__`` go through here, planned by
        :func:`repro_torch.core.select.plan_boxes`:

        * both axes contiguous → ONE range-mask kernel call;
        * a multi-interval ``Match``/``Where``/``Keys`` whose hits form ≤4
          rank boxes → one range-kernel call per box, OR-composed (the
          boxes are disjoint interval runs, so the OR is exact and the
          single downstream compaction is the only pass);
        * one axis boxable, the other scattered → the box calls AND one
          membership gather for the scattered axis;
        * both axes scattered → two membership gathers (no kernel).
        """
        from .select import plan_boxes

        rc, cc = self._compiled_pair(ij)
        nr = max(len(self.row_space), 1)
        nc = max(len(self.col_space), 1)
        boxes, row_gather, col_gather = plan_boxes(rc, cc, nr, nc)
        if row_gather and col_gather:
            _bump_dispatch("gather")
            return self._mask_keep(*self._device_masks(rc, cc))
        if len(boxes) > 1:
            _bump_dispatch("multirange")
        elif row_gather or col_gather:
            _bump_dispatch("hybrid")
        else:
            _bump_dispatch("range")
        keep = self._range_keep((int(boxes[0][0]), int(boxes[0][1])),
                                (int(boxes[0][2]), int(boxes[0][3])))
        for b in boxes[1:]:
            keep = keep | self._range_keep((int(b[0]), int(b[1])),
                                           (int(b[2]), int(b[3])))
        # membership mask built (and uploaded) ONLY for a scattered axis —
        # boxed axes are already handled by the kernel bounds
        if row_gather:
            keep = keep & coo_axis_mask_keep(self.rows,
                                             self._upload_mask(rc.mask()))
        if col_gather:
            keep = keep & coo_axis_mask_keep(self.cols,
                                             self._upload_mask(cc.mask()))
        return keep

    @contract(collectives=0,
              note="device selection: range kernel / masks, never dense")
    def __getitem__(self, ij) -> "AssocTensor":
        # thin wrapper over the one-node graph (see __add__)
        i, j = ij
        return Select(Source(self), i, j).collect()

    def _select_eager(self, ij) -> "AssocTensor":
        """Physical selection (the executor's device backend)."""
        return self._compact(self._selection_keep(ij))

    @contract(collectives=0,
              note="in-place value overwrite over stored entries")
    def __setitem__(self, ij, value) -> None:
        """Selector-targeted value update (in place, numeric scalar).

        Overwrites the values of *stored* entries inside the selection;
        the support is unchanged (inserting new entries is a host-side
        ``from_triples`` — the device layout is fixed-capacity).  This
        replaces ``self.vals`` on the object: the one mutating method.
        """
        if (not isinstance(value, (int, float, np.integer, np.floating))
                or isinstance(value, (bool, np.bool_))):
            raise TypeError("device __setitem__ takes a numeric scalar")
        if not self.numeric:
            raise TypeError("device __setitem__ requires numeric values")
        keep = self._selection_keep(ij)
        self.vals = torch.where(
            keep, torch.tensor(value, dtype=torch.float32, device=self.device),
            self.vals)

    # -- reductions ---------------------------------------------------------------
    #
    # Both axis reductions route through the shared reduce path in
    # repro_torch.core.plan (one scatter_combine implementation for the
    # Reduce node, eager calls, and the fused epilogue partials alike).

    def reduce_rows(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕-reduce over columns → dense vector over the row keyspace."""
        from .plan import device_axis_reduce
        return device_axis_reduce(self, 1, semiring)

    def reduce_cols(self, semiring=PLUS_TIMES) -> torch.Tensor:
        """⊕-reduce over rows → dense vector over the col keyspace."""
        from .plan import device_axis_reduce
        return device_axis_reduce(self, 0, semiring)

    def nnz_host(self) -> int:
        return int(self.nnz)


def _upload_map(m: np.ndarray, device) -> torch.Tensor:
    """Rank-translation table on ``device`` (a 1-entry dummy when empty, so
    the clamped gathers stay in bounds; its result is masked anyway)."""
    m = np.array(m, dtype=np.int32)          # a writable copy
    if len(m) == 0:
        m = np.zeros(1, np.int32)
    return torch.from_numpy(m).to(device)
