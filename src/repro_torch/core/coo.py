"""Canonical COO triple-store: the one primitive behind every Assoc op.

The paper's associative-array model is "sorted key sets + a sparse
adjacency"; every operation on it — constructor aggregation, element-wise
⊕ over the union of key sets, element-wise ⊗ over the intersection, array
multiplication, assignment — reduces to **canonicalizing a bag of COO
triples**: lexsort by (row, col), ⊕-merge duplicate runs, compact the
result.  D4M.jl routes all algebra through exactly this primitive; this
module is our single shared implementation of it with two backends:

* :func:`canonicalize_np` — host (numpy) backend over integer code arrays
  and numeric **or string** values.  Numeric merges use ``ufunc.reduceat``;
  string/generic merges use a run-offset doubling loop that is vectorized
  over runs (O(max-run-length) bulk steps, never a per-element Python loop).
* :func:`dedup_sorted_coo` — device (torch) backend over fixed-capacity
  sentinel-padded rank tensors, used by ``AssocTensor``; it runs without a
  host synchronisation.

Both backends share one contract: triples in, canonical sorted/merged
triples out.  ``Assoc`` (host) and ``AssocTensor`` (device) are thin views
over this layer; see also :func:`intersect_pairs_np` (rank-based sorted
intersection of key-pair sets) and :func:`spgemm_np` (host semiring
contraction via a vectorized sort-merge join).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .sorted_ops import INT_SENTINEL

__all__ = [
    "aggregate_runs",
    "apply_pair",
    "canonicalize_np",
    "intersect_pairs_np",
    "linearize_pairs_np",
    "spgemm_np",
    "spgemm_reduce_np",
    "expand_join_coo",
    "bucket_coo_by_range",
    "dedup_sorted_coo",
    "compact_to_front",
    "sort_key",
    "SENT",
]

SENT = int(INT_SENTINEL)

AggLike = Union[str, Callable]

# named/builtin aggregators → numpy ufuncs (numeric fast path: reduceat)
_UFUNCS = {
    "min": np.minimum, "max": np.maximum, "sum": np.add, "add": np.add,
    "prod": np.multiply, min: np.minimum, max: np.maximum, sum: np.add,
}

# named aggregators → object-array pair ops (string / generic fallback path)
_PAIR_OPS = {
    "min": lambda a, b: np.where(a <= b, a, b),
    "max": lambda a, b: np.where(a >= b, a, b),
    "sum": lambda a, b: a + b,
    "add": lambda a, b: a + b,
    "concat": lambda a, b: a + b,
    "prod": lambda a, b: a * b,
    min: lambda a, b: np.where(a <= b, a, b),
    max: lambda a, b: np.where(a >= b, a, b),
    sum: lambda a, b: a + b,
}


def _pair_fn(combine) -> Callable:
    fn = _PAIR_OPS.get(combine)
    if fn is not None:
        return fn
    if isinstance(combine, np.ufunc):
        return combine
    if callable(combine):
        ufn = np.frompyfunc(combine, 2, 1)
        return ufn
    raise ValueError(f"unknown aggregator {combine!r}")


def apply_pair(combine: AggLike, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Apply a two-operand aggregator elementwise — the run-length-≤-2 case.

    Merging two individually-canonical triple sets produces duplicate runs
    of length exactly 2, so the whole ⊕-merge is one vectorized pairwise
    application; ``a`` holds the left (first) operand's values.
    """
    if combine == "first":
        return a
    if combine == "last":
        return b
    if np.asarray(a).dtype.kind in "fiub":
        ufunc = _UFUNCS.get(combine)
        if ufunc is None and isinstance(combine, np.ufunc):
            ufunc = combine
        if ufunc is not None:
            return ufunc(a, b)
        return np.asarray(_pair_fn(combine)(a, b), dtype=np.asarray(a).dtype)
    out = _pair_fn(combine)(np.asarray(a).astype(object), b)
    return np.asarray(out.tolist() if isinstance(out, np.ndarray) else out,
                      dtype=str)


def aggregate_runs(vals: np.ndarray, starts: np.ndarray,
                   combine: AggLike) -> np.ndarray:
    """⊕-merge duplicate runs of a (row, col)-sorted value array.

    ``starts`` are the run-head positions (first index of each duplicate
    group).  Returns one merged value per run, combining left-to-right in
    the sorted (stable) order — so order-sensitive ⊕ like string
    concatenation sees values in input order.
    """
    vals = np.asarray(vals)
    n = len(vals)
    if len(starts) == n:          # no duplicates at all
        return vals
    ends = np.r_[starts[1:], n]
    if combine == "first":
        return vals[starts]
    if combine == "last":
        return vals[ends - 1]

    ufunc = _UFUNCS.get(combine)
    if ufunc is None and isinstance(combine, np.ufunc):
        ufunc = combine
    if ufunc is not None and vals.dtype.kind in "fiub":
        return ufunc.reduceat(vals, starts)

    # generic/string path: vectorized over runs, one bulk step per extra
    # run element (duplicate runs are short in practice: 2-operand merges
    # produce runs of length ≤ 2 ⇒ exactly one step).
    pair = _pair_fn(combine)
    lengths = ends - starts
    numeric = vals.dtype.kind in "fiub"
    # object accumulator: string results may outgrow the input itemsize
    acc = vals[starts].astype(object)
    for k in range(1, int(lengths.max())):
        sel = np.flatnonzero(lengths > k)
        acc[sel] = pair(acc[sel], vals[starts[sel] + k])
    return acc.astype(vals.dtype) if numeric else acc.astype(str)


def canonicalize_np(rows, cols, vals, combine: AggLike = "min"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host backend: lexsort + duplicate-run ⊕-merge + compaction.

    ``rows``/``cols`` are integer code (or rank) arrays, ``vals`` numeric or
    string values of the same length.  Returns ``(rows, cols, vals)`` sorted
    by ``(row, col)`` with every pair unique — the canonical triple form
    that both the paper's constructor and all element-wise algebra share.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if len(rows) == 0:
        return rows, cols, vals
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    new_run = np.r_[True, (r[1:] != r[:-1]) | (c[1:] != c[:-1])]
    starts = np.flatnonzero(new_run)
    return r[starts], c[starts], aggregate_runs(v, starts, combine)


def linearize_pairs_np(rows, cols, ncols: int) -> np.ndarray:
    """(row, col) code pairs → one int64 linear code per pair.

    ``code = row * ncols + col`` — a total order on key pairs that lets
    element-wise intersection/masking run as a sorted-set operation on
    integers (:func:`intersect_pairs_np`) instead of per-element probing.
    """
    return (np.asarray(rows).astype(np.int64) * np.int64(max(int(ncols), 1))
            + np.asarray(cols))


def intersect_pairs_np(lin_a: np.ndarray, lin_b: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-based sorted intersection of two unique (row, col) pair-code sets.

    ``lin_a``/``lin_b`` are int64 linearized pair codes (``row * ncols +
    col`` over a shared keyspace).  Returns positions ``(ia, ib)`` into each
    input such that ``lin_a[ia] == lin_b[ib]`` — the paper's element-wise
    intersection without any per-element dictionary probing.
    """
    _, ia, ib = np.intersect1d(lin_a, lin_b, assume_unique=True,
                               return_indices=True)
    return ia, ib


def spgemm_np(a_row, a_k, a_val, b_k, b_col, b_val,
              mul: Callable, add: AggLike
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host semiring contraction ``C[i,j] = ⊕_k A[i,k] ⊗ B[k,j]`` on codes.

    ``(a_row, a_k, a_val)`` are A's triples with contraction codes ``a_k``;
    ``(b_k, b_col, b_val)`` are B's triples **sorted by** ``b_k``.  The join
    is a vectorized sort-merge: each A entry expands against its B run via
    ``searchsorted`` + ``repeat``, products are formed in bulk with ⊗, and
    one :func:`canonicalize_np` pass ⊕-merges them.  No Python loops.
    """
    empty = (np.empty(0, a_row.dtype if len(a_row) else np.int64),
             np.empty(0, b_col.dtype if len(b_col) else np.int64),
             np.empty(0, np.float64))
    if len(a_row) == 0 or len(b_k) == 0:
        return empty
    lo = np.searchsorted(b_k, a_k, side="left")
    hi = np.searchsorted(b_k, a_k, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return empty
    a_idx = np.repeat(np.arange(len(a_row)), counts)
    run_base = np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(lo, counts) + (np.arange(total) - run_base)
    rows = a_row[a_idx]
    cols = b_col[b_idx]
    vals = mul(a_val[a_idx], b_val[b_idx])
    return canonicalize_np(rows, cols, vals, combine=add)


def spgemm_reduce_np(a_row, a_k, a_val, b_k, b_col, b_val,
                     mul: Callable, add_np: np.ufunc, zero: float,
                     axis: int, n_out: int) -> np.ndarray:
    """Fused host contraction + ⊕-reduction: never materializes C.

    Computes ``⊕_j C[i, j]`` (``axis=1``, vector over A's row codes) or
    ``⊕_i C[i, j]`` (``axis=0``, vector over B's col codes) for
    ``C = A ⊗.⊕ B`` — since ⊕ is associative and commutative the reduction
    folds directly over the expanded products, so the canonicalize pass (and
    C's triples) are skipped entirely.  Same operand layout as
    :func:`spgemm_np`; ``add_np`` must be a true ufunc (``.at`` scatter).
    Graphulo's server-side combine, on host: one segment scatter per product.
    """
    out = np.full(n_out, zero, dtype=np.float64)
    if len(a_row) == 0 or len(b_k) == 0:
        return out
    lo = np.searchsorted(b_k, a_k, side="left")
    hi = np.searchsorted(b_k, a_k, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return out
    a_idx = np.repeat(np.arange(len(a_row)), counts)
    run_base = np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(lo, counts) + (np.arange(total) - run_base)
    keys = a_row[a_idx] if axis == 1 else b_col[b_idx]
    vals = np.asarray(mul(a_val[a_idx], b_val[b_idx]), dtype=np.float64)
    add_np.at(out, keys, vals)
    return out


# ---------------------------------------------------------------------------
# Device backend: sort + duplicate-run aggregation on fixed-capacity,
# sentinel-padded rank triples (torch, any device).
#
# Given COO triples (possibly with duplicates and sentinel padding), produce
# the canonical form: sorted by (row, col), duplicates merged with ⊕, valid
# entries compacted to the front, tail sentinel-padded.  This one primitive
# implements the paper's constructor aggregation AND both element-wise ops
# (union-with-⊕ and run-length-2 intersection-with-⊗).  No step reads a
# count back to the host: compaction scatters into a buffer with one spare
# slot that absorbs every dropped entry.
# ---------------------------------------------------------------------------

# ⊕ callables with a native scatter reduction; any other callable runs the
# log-step doubling scan
_SCATTER_KIND = {torch.add: "sum", torch.maximum: "amax",
                 torch.minimum: "amin"}


def sort_key(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 ``row·2³¹ + col`` — sorting it (stably) is a (row, col)
    lexsort; sentinel rows sort last because SENT is the int32 maximum."""
    return rows.to(torch.int64) * (2 ** 31) + cols.to(torch.int64)


def compact_to_front(keep: torch.Tensor, *cols_fill):
    """Stable-compact the ``keep`` entries of each ``(tensor, fill)`` to the
    front of a same-length tensor whose tail holds ``fill``."""
    n = keep.shape[0]
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    outs = []
    for t, fill in cols_fill:
        out = torch.full((n + 1,), fill, dtype=t.dtype, device=t.device)
        out[dest] = t
        outs.append(out[:n])
    return outs


def _segment_combine(v, seg, ok, combine, cap):
    """⊕ of each run of ``v`` (runs numbered by ``seg``) → [cap] by run id."""
    kind = _SCATTER_KIND.get(combine)
    if kind is not None:
        out = torch.zeros(cap, dtype=v.dtype, device=v.device)
        return out.scatter_reduce_(0, seg, v, reduce=kind, include_self=False)
    # arbitrary associative ⊕: inclusive doubling scan, then read each
    # run's last element (which holds the run's full ⊕)
    ar = torch.arange(cap, device=v.device)
    acc, step = v, 1
    while step < cap:
        same = (torch.roll(seg, step) == seg) & (ar >= step)
        contrib = same & torch.roll(ok, step) & ok
        acc = torch.where(contrib, combine(acc, torch.roll(acc, step)), acc)
        step *= 2
    last = torch.zeros(cap, dtype=torch.int64, device=v.device)
    last.scatter_reduce_(0, seg, ar, reduce="amax", include_self=False)
    return acc[last]


def dedup_sorted_coo(rows, cols, vals, combine, *, zero: float = 0.0,
                     require_pair: bool = False, pair_op=None,
                     src: Optional[torch.Tensor] = None):
    """Canonicalize COO triples on device (shape-static, no host sync).

    Parameters
    ----------
    rows, cols: int32[cap] rank tensors; sentinel-padded entries are dropped.
    vals:       float[cap] values.
    combine:    ⊕ used to merge duplicate (row, col) runs (semiring add or an
                aggregation op).  Must be associative & commutative.
    require_pair: if True, keep ONLY entries forming a cross-source duplicate
                pair (element-wise intersection); ``src`` flags the source
                array (0/1) and ``pair_op`` is the ⊗ applied across the pair.
    Returns (rows, cols, vals, nnz) in canonical sorted/padded form: the
    tail holds SENT ranks and ``zero`` values, ``nnz`` is a 0-dim int32.
    """
    cap = rows.shape[0]
    dev = rows.device
    if cap == 0:
        return rows, cols, vals, torch.zeros((), dtype=torch.int32, device=dev)
    valid = rows != SENT
    # stable (row, col) sort: the dedup ⊕ and the pair orientation rely on
    # ties keeping their input order
    order = torch.sort(sort_key(rows, cols), stable=True).indices
    r, c, v, ok = rows[order], cols[order], vals[order], valid[order]

    same_as_prev = torch.zeros(cap, dtype=torch.bool, device=dev)
    same_as_prev[1:] = (r[1:] == r[:-1]) & (c[1:] == c[:-1]) & ok[1:]

    if require_pair:
        # intersection: inputs are individually dedup'd, so runs have length
        # ≤ 2 and a pair always spans both sources.
        s = src[order]
        same_as_next = torch.zeros(cap, dtype=torch.bool, device=dev)
        same_as_next[:-1] = same_as_prev[1:]
        nxt = (torch.arange(cap, device=dev) + 1).clamp(max=cap - 1)
        a_val = torch.where(s == 0, v, v[nxt])   # value from source 0
        b_val = torch.where(s == 0, v[nxt], v)   # value from source 1
        v = pair_op(a_val, b_val)
        keep = same_as_next & ok
    else:
        head = ~same_as_prev
        seg = torch.cumsum(head, 0) - 1
        v = _segment_combine(v, seg, ok, combine, cap)[seg]
        keep = head & ok

    # drop zeros ("empty" values are unstored, matching the paper)
    keep = keep & (v != zero)
    r, c, v = compact_to_front(keep, (r, SENT), (c, SENT), (v, zero))
    return r, c, v, keep.sum().to(torch.int32)


def expand_join_coo(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals,
                    mul, *, zero: float, expand: int):
    """Device sort-merge join of two COO operands (shape-static).

    The device mirror of :func:`spgemm_np`'s expansion step: contraction
    codes are A's cols and B's rows; B must be in canonical (row, col) order.
    Each A entry expands against its B run via two ``searchsorted`` calls;
    the expansion is laid out into a static ``expand``-sized buffer
    (products beyond it are dropped — callers size ``expand`` from host-side
    exact counts).  Returns pre-⊕ product triples ``(rows, cols, vals,
    total)`` with sentinel padding; ⊕-merging them is one
    :func:`dedup_sorted_coo` pass (or a direct segment scatter for the fused
    reduce epilogues).

    Never densifies: peak memory is the two operands plus ``expand``
    product slots.
    """
    cap_a = a_rows.shape[0]
    cap_b = b_rows.shape[0]
    dev = a_rows.device
    if cap_a == 0 or cap_b == 0:
        sent = torch.full((expand,), SENT, dtype=torch.int32, device=dev)
        return sent, sent.clone(), torch.full(
            (expand,), zero, dtype=torch.float32, device=dev), \
            torch.zeros((), dtype=torch.int32, device=dev)
    b_sorted = b_rows.to(torch.int32).contiguous()
    a_k = a_cols.to(torch.int32).contiguous()
    lo = torch.searchsorted(b_sorted, a_k, right=False)
    hi = torch.searchsorted(b_sorted, a_k, right=True)
    ok = a_rows != SENT
    counts = torch.where(ok, hi - lo, 0)
    cum = torch.cumsum(counts, 0)
    total = cum[cap_a - 1]
    e = torch.arange(expand, dtype=torch.int64, device=dev)
    # which A entry produced product slot e: first index with cum > e
    a_of = torch.searchsorted(cum, e, right=True).clamp(0, cap_a - 1)
    start = cum[a_of] - counts[a_of]
    b_idx = (lo[a_of] + (e - start)).clamp(0, cap_b - 1)
    valid = e < total
    rows = torch.where(valid, a_rows[a_of], SENT).to(torch.int32)
    cols = torch.where(valid, b_cols[b_idx], SENT).to(torch.int32)
    vals = torch.where(valid, mul(a_vals[a_of], b_vals[b_idx]),
                       torch.tensor(zero, dtype=a_vals.dtype, device=dev))
    return rows, cols, vals, total.to(torch.int32)


def bucket_coo_by_range(rows, cols, vals, bounds, n_buckets: int,
                        bucket_cap: int, *, zero: float):
    """Scatter COO triples into ``[n_buckets, bucket_cap]`` buckets keyed by
    the range of ``rows`` (shape-static, no host sync).

    The routing step of the sharded-B all-to-all product: partial products
    land on the shard that owns their output row, so each producer buckets
    its triples by ``searchsorted(bounds[1:], rows)`` before the exchange.
    ``bounds`` is the ``[n_buckets+1]`` rank-boundary tensor (the
    ``row_bounds`` of the DistAssoc partition); sentinel rows and bucket
    overflow beyond ``bucket_cap`` are dropped — callers size
    ``bucket_cap`` from host-side exact counts so the main path never
    overflows.  Within a bucket the triples keep their input order.
    Returns ``(rows, cols, vals)`` each shaped ``[n_buckets, bucket_cap]``,
    sentinel/zero padded.
    """
    dev = rows.device
    ok = rows != SENT
    dest = torch.searchsorted(bounds[1:].to(torch.int64).contiguous(),
                              rows.to(torch.int64), right=True)
    dest = torch.where(ok, dest, n_buckets)        # invalid → dropped
    order = torch.sort(dest, stable=True).indices
    d = dest[order]
    # rank within bucket: position minus the bucket's run start
    slot = (torch.arange(rows.shape[0], device=dev)
            - torch.searchsorted(d, d, right=False))
    keep = (d < n_buckets) & (slot < bucket_cap)
    size = n_buckets * bucket_cap
    flat = torch.where(keep, d * bucket_cap + slot, size)
    outs = []
    for t, fill in ((rows, SENT), (cols, SENT), (vals, zero)):
        out = torch.full((size + 1,), fill, dtype=t.dtype, device=dev)
        out[flat] = t[order]
        outs.append(out[:size].reshape(n_buckets, bucket_cap))
    return tuple(outs)
