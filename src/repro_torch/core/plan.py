"""Planner + executor for lazy D4M expressions (the other half of expr.py).

``collect()`` hands an expression graph here.  The planner rewrites it
before anything executes:

* **selector pushdown** — ``Select`` nodes move through ``Transpose``
  (axes swap), element-wise ⊕/⊗ (applied to both operands) and ``MatMul``
  (row selection to A, column selection to B), and adjacent selections
  compose with the selector algebra's ``&``.  Only *key-based* selectors
  are pushed (``Keys``/``Range``/``StartsWith``/``Match``/``Where`` and
  their ``&``/``|``/``~`` compositions): their membership is a pure
  predicate of the key, so it commutes with any keyspace change the
  operation makes.  ``Positions``/``Mask`` address ranks of the *result*
  keyspace and stay put.
* **select→matmul fusion** — a selection sitting on a matmul operand is
  compiled (``select.py`` compiled forms) and folded into the spgemm
  plan: the packed-tile lists and rank ranges are sliced on host and the
  values gathered once, so the sliced operand is **never built as an
  array** (no compact, no sort, no canonicalize).
* **MatMul→Reduce fusion** — ``Reduce(MatMul(a, b, sr), axis, sr)``
  collapses onto the fused ``matmul_reduce`` epilogues (the
  ``sqin``/``sqout`` family): C is never materialized on any layer.
* **ewise-chain fusion** — ``A ⊕ B ⊕ C ⊕ …`` under one semiring runs as a
  single canonicalize pass over all operands' triples instead of one pass
  per ``⊕``.
* **hash-consing** — repeated subtrees (same sources, same structure)
  execute once per ``collect()``; ``PLAN_STATS`` counts hits/misses and
  the rewrites, mirroring ``UNION_STATS``/``DISPATCH_STATS``.

The executor then evaluates the optimized graph on whichever layer the
sources live on — host ``Assoc``, device ``AssocTensor`` or sharded
``DistAssoc`` — by dispatching to the layers' *physical* methods.  Eager
operators are thin wrappers that build a one-node graph and collect it, so
lazy and eager share this single execution path.

This module also hosts the **shared axis-reduction path**
(:func:`host_axis_reduce` / :func:`device_axis_reduce`): ``Assoc.sum``,
``AssocTensor.reduce_rows``/``reduce_cols`` and the ``Reduce`` node all
route through it, so reduction dtype/zero rules come from the combine
helpers (``scatter_combine`` / ``add_np``) in one place.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from .assoc_tensor import _upload_map, coo_range_keep
from .coo import SENT, canonicalize_np, dedup_sorted_coo
from .expr import (EwiseAdd, EwiseMul, LazyExpr, MatMul, Reduce, Select,
                   Source, Transpose)
from .select import (All, And, Compiled, Keys, Match, Not, Or, Range,
                     StartsWith, Where, as_selector, compile_selector)
from .semiring import PLUS_TIMES, get_semiring, scatter_combine
from .sorted_ops import sorted_intersect, sorted_union

__all__ = ["execute", "optimize", "PLAN_STATS", "reset_plan_stats",
           "clear_plan_cache", "host_axis_reduce", "device_axis_reduce",
           "host_matmul"]


# Planner/executor telemetry, matching UNION_STATS / DISPATCH_STATS /
# CACHE_STATS: hash-consing hit/miss counts plus one counter per rewrite
# family, so tests and benchmarks can assert a fusion actually fired.
# ``plan_hits``/``plan_misses`` count the *cross-collect* plan cache: a
# repeated pipeline (same structural key over the same source arrays)
# skips the optimize() walk entirely on its second and later collects.
PLAN_STATS = {
    "hits": 0, "misses": 0,
    "plan_hits": 0, "plan_misses": 0,
    "pushdown": 0, "fused_matmul_reduce": 0,
    "fused_select_matmul": 0, "ewise_fused": 0,
    "reduce_through_add": 0, "fused_select_ewise": 0,
    # distributed matmul strategy choices (DistAssoc.matmul/_reduce):
    # which communication pattern the cost model — or an explicit impl=
    # override — actually ran
    "dist_replicate": 0, "dist_all_to_all": 0, "dist_2d": 0,
    # plan-cache entries dropped because a compaction (repro.ingest)
    # retired the Source arrays they were keyed on
    "plan_invalidations": 0,
}


# One lock guards the plan cache's LRU mutation AND the PLAN_STATS bumps:
# a concurrent server collects from many worker threads, and OrderedDict
# move_to_end/popitem under concurrent mutation corrupts the dict.  RLock
# (not Lock) because reset_plan_stats() -> clear_plan_cache() re-enters.
_PLAN_LOCK = threading.RLock()


def _bump(key: str, n: int = 1) -> None:
    """Locked PLAN_STATS increment (dict ``+=`` is a read-modify-write —
    concurrent collects would silently lose counts)."""
    with _PLAN_LOCK:
        PLAN_STATS[key] += n


def reset_plan_stats() -> None:
    """Zero the counters AND cold-start the planner (plan cache cleared):
    a fresh measurement window should see its own misses and rewrites, not
    inherit plans memoized by earlier pipelines."""
    with _PLAN_LOCK:
        for k in PLAN_STATS:
            PLAN_STATS[k] = 0
        clear_plan_cache()


# Cross-collect plan cache: optimized graph memoized by the hash-consed
# structural key (expr.key(): node structure + id() of source arrays and
# opaque selectors).  Identity keys cannot go stale while an entry lives —
# the cached graph itself pins its Source arrays and selector objects, so
# their ids are not reusable — and in-place value mutation is safe because
# the cache stores the *rewrite*, never results.  LRU-bounded so pinned
# arrays cannot accumulate without bound.
_PLAN_CACHE: "OrderedDict[tuple, LazyExpr]" = OrderedDict()
_PLAN_CACHE_CAP = 256


def clear_plan_cache() -> None:
    """Invalidation hook: drop every memoized optimized plan (and with it
    the pinned references to their source arrays/selectors)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


def _key_touches(key, ids: set) -> bool:
    """Does a structural plan key reference any ``("src", id)`` leaf with
    an id in ``ids``?  Keys are nested tuples (expr.key())."""
    if isinstance(key, tuple):
        if len(key) == 2 and key[0] == "src" and key[1] in ids:
            return True
        return any(_key_touches(k, ids) for k in key)
    return False


def invalidate_plan_for(array_ids) -> int:
    """Targeted invalidation: drop every cached plan whose key references
    one of ``array_ids`` (``id()`` of retired Source arrays).

    Used by ingest compaction (:mod:`repro.ingest`): the compacted table's
    old base and merged snapshots are retired, and any plan keyed on them
    would pin the dead arrays until LRU eviction.  Identity keys cannot
    serve stale *results* (the new base is a new object ⇒ new key); this
    hook reclaims the memory and keeps the LRU hot for live tables.
    """
    ids = set(array_ids)
    if not ids:
        return 0
    with _PLAN_LOCK:
        drop = [k for k in _PLAN_CACHE if _key_touches(k, ids)]
        for k in drop:
            del _PLAN_CACHE[k]
        PLAN_STATS["plan_invalidations"] += len(drop)
    return len(drop)


def _layer(x) -> str:
    from .assoc import Assoc
    from .assoc_tensor import AssocTensor
    from .dist_assoc import DistAssoc
    if isinstance(x, Assoc):
        return "host"
    if isinstance(x, AssocTensor):
        return "device"
    if isinstance(x, DistAssoc):
        return "dist"
    raise TypeError(f"not an associative array: {type(x)!r}")


# ---------------------------------------------------------------------------
# Rewrite pass 1: selector pushdown
# ---------------------------------------------------------------------------

def _pushable(sel) -> bool:
    """True iff the selector's membership is a pure predicate of the key.

    Such selectors commute with transpose/ewise/matmul and compose with
    ``&`` across nested selections.  ``Positions``/``Mask``/non-trivial
    slices address ranks of a *specific* keyspace and must not move.
    """
    try:
        s = as_selector(sel)
    except TypeError:
        return False
    if isinstance(s, (Keys, Range, StartsWith, Match, Where, All)):
        return True
    if isinstance(s, (And, Or)):
        return _pushable(s.a) and _pushable(s.b)
    if isinstance(s, Not):
        return _pushable(s.a)
    return False


def _push(node: LazyExpr) -> LazyExpr:
    if isinstance(node, Source):
        return node
    if isinstance(node, Select):
        child = node.child
        rs, cs = node.row_sel, node.col_sel
        if isinstance(child, Select) and all(
                _pushable(s) for s in (rs, cs, child.row_sel, child.col_sel)):
            _bump("pushdown")
            return _push(Select(child.child,
                                as_selector(child.row_sel) & as_selector(rs),
                                as_selector(child.col_sel) & as_selector(cs)))
        if _pushable(rs) and _pushable(cs):
            if isinstance(child, Transpose):
                _bump("pushdown")
                return Transpose(_push(Select(child.child, cs, rs)))
            if isinstance(child, (EwiseAdd, EwiseMul)):
                _bump("pushdown")
                return type(child)(_push(Select(child.a, rs, cs)),
                                   _push(Select(child.b, rs, cs)),
                                   semiring=child.semiring)
            if isinstance(child, MatMul):
                _bump("pushdown")
                return MatMul(_push(Select(child.a, rs, All())),
                              _push(Select(child.b, All(), cs)),
                              semiring=child.semiring)
        return Select(_push(child), rs, cs)
    if isinstance(node, Transpose):
        return Transpose(_push(node.child))
    if isinstance(node, Reduce):
        return Reduce(_push(node.child), node.axis, node.semiring)
    if isinstance(node, (EwiseAdd, EwiseMul, MatMul)):
        return type(node)(_push(node.a), _push(node.b),
                          semiring=node.semiring)
    return node


# ---------------------------------------------------------------------------
# Rewrite pass 2: fusion (internal physical nodes)
# ---------------------------------------------------------------------------

class _MatMulReduce(LazyExpr):
    """Fused ``⊕-reduce(a ⊗.⊕ b, axis)`` — executes via matmul_reduce."""

    def __init__(self, a, b, axis, semiring):
        self.a, self.b, self.axis = a, b, axis
        self.semiring = semiring

    def key(self):
        return ("mmr", self.a.key(), self.b.key(), self.axis,
                self.semiring.name)


class _EwiseAddN(LazyExpr):
    """n-ary fused ⊕ chain — one canonicalize pass over all operands."""

    def __init__(self, terms, semiring):
        self.terms = list(terms)
        self.semiring = semiring

    def key(self):
        return ("ewise_add_n", tuple(t.key() for t in self.terms),
                self.semiring.name)


class _ReduceAddN(LazyExpr):
    """Fused ``⊕-reduce(t₁ ⊕ t₂ ⊕ …, axis)`` — the Reduce-through-EwiseAdd
    rewrite.  Valid when the ⊕ of the chain IS the reduction combine (same
    ``add_kind`` monoid): then ⊕-folding every term's entries straight into
    the output vector equals reducing the materialized merge, and the
    concat + canonicalize sort of the merge never happens.  Keeps the ewise
    semiring too: the executor's non-numeric fallback must materialize with
    the chain's own ⊕."""

    def __init__(self, terms, axis, semiring, ewise_semiring):
        self.terms = list(terms)
        self.axis = axis
        self.semiring = semiring
        self.ewise_semiring = ewise_semiring

    def key(self):
        return ("reduce_add_n", tuple(t.key() for t in self.terms),
                self.axis, self.semiring.name, self.ewise_semiring.name)


def _flatten_add(node, sr) -> List[LazyExpr]:
    if isinstance(node, EwiseAdd) and node.semiring.name == sr.name:
        return _flatten_add(node.a, sr) + _flatten_add(node.b, sr)
    return [node]


def _fuse(node: LazyExpr) -> LazyExpr:
    if isinstance(node, Source):
        return node
    if isinstance(node, Reduce):
        child = _fuse(node.child)
        if (isinstance(child, MatMul) and node.axis is not None
                and child.semiring.name == node.semiring.name):
            _bump("fused_matmul_reduce")
            return _MatMulReduce(child.a, child.b, node.axis, child.semiring)
        if (isinstance(child, (EwiseAdd, _EwiseAddN))
                and node.axis is not None
                and child.semiring.add_kind == node.semiring.add_kind):
            # reduce(A ⊕ B) → scatter both operands' entries into the
            # reduce vector directly.  add_kind equality is the exact
            # condition: it names the ⊕ monoid (sum/max/min) for every
            # registered semiring, so the chain's ⊕ and the reduction
            # combine are the same associative-commutative op and the
            # per-entry fold order cannot matter.
            _bump("reduce_through_add")
            terms = (child.terms if isinstance(child, _EwiseAddN)
                     else [child.a, child.b])
            return _ReduceAddN(terms, node.axis, node.semiring,
                               child.semiring)
        return Reduce(child, node.axis, node.semiring)
    if isinstance(node, EwiseAdd):
        terms = _flatten_add(node, node.semiring)
        if len(terms) >= 3:
            _bump("ewise_fused")
            return _EwiseAddN([_fuse(t) for t in terms], node.semiring)
        return EwiseAdd(_fuse(node.a), _fuse(node.b), semiring=node.semiring)
    if isinstance(node, (EwiseMul, MatMul)):
        return type(node)(_fuse(node.a), _fuse(node.b),
                          semiring=node.semiring)
    if isinstance(node, Select):
        return Select(_fuse(node.child), node.row_sel, node.col_sel)
    if isinstance(node, Transpose):
        return Transpose(_fuse(node.child))
    return node


def optimize(node: LazyExpr) -> LazyExpr:
    """Rewrite an expression graph: pushdown first, then fusion."""
    return _fuse(_push(node))


# ---------------------------------------------------------------------------
# Execution (hash-consed)
# ---------------------------------------------------------------------------

_MISS = object()


def _single_node_fast(node: LazyExpr):
    """Dispatch a one-node graph (what every eager wrapper builds)
    straight to the physical backend — no rewrite walk, no memo, no
    structural keys.  Returns ``_MISS`` for anything deeper."""
    if isinstance(node, Select) and isinstance(node.child, Source):
        return node.child.array._select_eager((node.row_sel, node.col_sel))
    if isinstance(node, (EwiseAdd, EwiseMul, MatMul)) \
            and isinstance(node.a, Source) and isinstance(node.b, Source):
        a, b = node.a.array, node.b.array
        if isinstance(node, MatMul):
            if _layer(a) != "dist" and _layer(b) == "dist":
                b = b.gather_replicated()  # same rule as _eval_matmul
            return a.matmul(b, node.semiring)
        _require_same_layer(a, b, "⊕" if isinstance(node, EwiseAdd) else "⊗")
        if isinstance(node, EwiseAdd):
            return a.add(b, node.semiring)
        return a.mul(b, node.semiring)
    return _MISS


def execute(node: LazyExpr):
    """Optimize + evaluate; repeated subtrees run once and repeated
    *collects* of the same graph reuse the optimized plan (PLAN_STATS)."""
    fast = _single_node_fast(node)
    if fast is not _MISS:
        return fast
    key = node.key()
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            PLAN_STATS["plan_hits"] += 1
            _PLAN_CACHE.move_to_end(key)
    if plan is None:
        # optimize() outside the lock: rewrites are pure and idempotent, so
        # two threads racing the same cold key just do the walk twice and
        # one insert wins — cheaper than serializing every cold plan.
        plan = optimize(node)
        with _PLAN_LOCK:
            PLAN_STATS["plan_misses"] += 1
            if key not in _PLAN_CACHE:
                _PLAN_CACHE[key] = plan
                if len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
                    _PLAN_CACHE.popitem(last=False)
    return _eval(plan, {})


def _eval(node: LazyExpr, memo: dict):
    if isinstance(node, Source):
        return node.array
    k = node.key()
    if k in memo:
        _bump("hits")
        return memo[k]
    _bump("misses")
    out = _eval_inner(node, memo)
    memo[k] = out
    return out


def _strip_select(node) -> Tuple[LazyExpr, Optional[tuple]]:
    """Peel one Select off a matmul operand for select→matmul fusion.

    ``Transpose(Select(x, r, c))`` is ``Select(Transpose(x), c, r)`` for
    *every* selector form — transpose swaps the keyspaces without changing
    either — so a selection under a transpose fuses too (the ``sqin`` /
    ``sqout`` shapes)."""
    if isinstance(node, Select):
        return node.child, (node.row_sel, node.col_sel)
    if isinstance(node, Transpose) and isinstance(node.child, Select):
        s = node.child
        return Transpose(s.child), (s.col_sel, s.row_sel)
    return node, None


def _eval_inner(node: LazyExpr, memo: dict):
    if isinstance(node, Select):
        arr = _eval(node.child, memo)
        _layer(arr)  # clean TypeError when the child is not an array
        return arr._select_eager((node.row_sel, node.col_sel))
    if isinstance(node, Transpose):
        arr = _eval(node.child, memo)
        if _layer(arr) == "dist":
            # the transpose breaks the row partition: gather to a
            # replicated device tensor (the rule a dist sqin follows)
            return arr.gather_replicated().transpose()
        return arr.transpose()
    if isinstance(node, EwiseAdd):
        a_node, asels = _strip_select(node.a)
        b_node, bsels = _strip_select(node.b)
        if asels is not None or bsels is not None:
            # the pushdown's (A ⊕ B)[sel] → A[sel] ⊕ B[sel] shape: fold
            # the selections into the one canonical merge instead of
            # materializing each slice (compact per operand)
            a, b = _eval(a_node, memo), _eval(b_node, memo)
            _require_same_layer(a, b, "⊕")
            return _fused_select_add(a, asels, b, bsels, node.semiring)
        a, b = _eval(node.a, memo), _eval(node.b, memo)
        _require_same_layer(a, b, "⊕")
        return a.add(b, node.semiring)
    if isinstance(node, EwiseMul):
        a, b = _eval(node.a, memo), _eval(node.b, memo)
        _require_same_layer(a, b, "⊗")
        return a.mul(b, node.semiring)
    if isinstance(node, MatMul):
        return _eval_matmul(node.a, node.b, node.semiring, None, memo)
    if isinstance(node, _MatMulReduce):
        return _eval_matmul(node.a, node.b, node.semiring, node.axis, memo)
    if isinstance(node, Reduce):
        arr = _eval(node.child, memo)
        if isinstance(arr, (float, np.floating, np.ndarray, torch.Tensor)):
            # reducing an already-reduced result: only the full ⊕ is left
            if node.axis is not None:
                raise ValueError(
                    "axis reduction of an already-reduced result; "
                    "use .sum() for the remaining full ⊕")
            if isinstance(arr, (float, np.floating)):
                return arr                  # ⊕ over a single scalar
            sr = get_semiring(node.semiring)
            if isinstance(arr, np.ndarray):
                return float(sr.add_np.reduce(arr)) if arr.size \
                    else float(sr.zero)
            return sr.add_reduce(arr) if arr.numel() else torch.tensor(
                sr.zero, dtype=torch.float32, device=arr.device)
        return _axis_reduce(arr, node.axis, node.semiring)
    if isinstance(node, _EwiseAddN):
        terms = [_eval(t, memo) for t in node.terms]
        return _add_n(terms, node.semiring)
    if isinstance(node, _ReduceAddN):
        terms = [_eval(t, memo) for t in node.terms]
        return _reduce_add_n(terms, node.axis, node.semiring,
                             node.ewise_semiring)
    raise TypeError(f"cannot execute node {node!r}")


def _require_same_layer(a, b, what: str) -> None:
    la, lb = _layer(a), _layer(b)
    if la != lb:
        raise TypeError(f"element-wise {what} across layers "
                        f"({la} vs {lb}); convert one operand first")


def _eval_matmul(a_node, b_node, sr, axis, memo):
    a_node, asels = _strip_select(a_node)
    b_node, bsels = _strip_select(b_node)
    a = _eval(a_node, memo)
    b = _eval(b_node, memo)
    if _layer(a) != "dist" and _layer(b) == "dist":
        # a transposed (hence gathered) A against a still-sharded B: pull
        # B to a replicated device tensor
        b = b.gather_replicated()
    if asels is None and bsels is None:
        if axis is None:
            return a.matmul(b, sr)
        return a.matmul_reduce(b, axis, sr)
    _bump("fused_select_matmul")
    layer = _layer(a)
    if layer == "host":
        return host_matmul(a, asels, b, bsels, sr, axis)
    if layer == "device":
        return _device_fused_matmul(a, asels, b, bsels, sr, axis)
    return _dist_fused_matmul(a, asels, b, bsels, sr, axis)


# ---------------------------------------------------------------------------
# Compiled-selection helpers (shared by the fused paths)
# ---------------------------------------------------------------------------

def _member(comp: Compiled, codes: np.ndarray) -> Optional[np.ndarray]:
    """Membership of rank codes in a compiled selection (None ⇒ selects
    everything — no filtering needed)."""
    if comp.count == comp.n:
        return None
    if comp.is_range:
        return (codes >= comp.lo) & (codes < comp.hi)
    # comp.n == 0 cannot reach here: count == n returned None above
    return comp.mask()[np.clip(codes, 0, comp.n - 1)] & (codes < comp.n)


def _entry_keep(rc: Compiled, cc: Compiled, rows: np.ndarray,
                cols: np.ndarray) -> Optional[np.ndarray]:
    """AND of row/col membership over entry code arrays (None ⇒ keep all)."""
    keep = None
    rm = _member(rc, rows)
    cm = _member(cc, cols)
    for m in (rm, cm):
        if m is not None:
            keep = m if keep is None else (keep & m)
    return keep


def _range_box(rc: Compiled, cc: Compiled) -> Optional[tuple]:
    """The rank box ``(row_lo, row_hi, col_lo, col_hi)`` of a selection
    that compiles to a range on both axes and keeps less than everything:
    on a device shard its keep mask is the range-mask kernel's, as an
    eager selection's range path; None otherwise."""
    if not (rc.is_range and cc.is_range) or (rc.count == rc.n
                                             and cc.count == cc.n):
        return None
    return (rc.lo, rc.hi, cc.lo, cc.hi)


# ---------------------------------------------------------------------------
# Fused select→matmul, host layer
# ---------------------------------------------------------------------------

def _host_entry_keep(a, coo, sels) -> Optional[np.ndarray]:
    if sels is None:
        return None
    rc = compile_selector(sels[0], a._axis_space(a.row))
    cc = compile_selector(sels[1], a._axis_space(a.col))
    return _entry_keep(rc, cc, coo.row, coo.col)


def host_matmul(a, asels, b, bsels, sr, axis=None):
    """Host ``⊗.⊕`` contraction (+ optional fused selection/reduction).

    With ``asels``/``bsels`` = None this is THE host semiring
    contraction — ``Assoc.matmul`` and ``Assoc.matmul_reduce`` delegate
    here, so the sort-merge join prologue exists once.  With selections,
    it is select+matmul(+reduce) without materializing either slice:
    ``(+,×)`` keeps scipy's CSR engine — deselected entries have their
    *data* zeroed in place (a value mask, not a re-indexing), so the
    product — and the fused matvec reduction — run on the full-shape
    operands and zero contributions vanish on their own.  Other semirings
    run the filtered expand-join (``spgemm_np`` / ``spgemm_reduce_np``)
    over the kept entries only.

    Note on reduce alignment: the ``axis=1`` vector is indexed by the
    *unsliced* ``a.row`` (deselected rows hold the ⊕-identity), unlike an
    eager ``(A[sel] @ B).sum(axis=1)`` whose host result condensed its
    keyspace first — on device the two agree because device selection
    never shrinks keyspaces.
    """
    import scipy.sparse as sp

    from .assoc import Assoc
    from .coo import spgemm_np, spgemm_reduce_np

    sr = get_semiring(sr)
    a0 = a if a.numeric else a.logical()
    b0 = b if b.numeric else b.logical()
    n_out = len(a0.row) if axis == 1 else len(b0.col)
    inner, ia, ib = sorted_intersect(a0.col, b0.row)
    if len(inner) == 0 or a0.nnz() == 0 or b0.nnz() == 0:
        if axis is None:
            return Assoc()
        return np.full(n_out, sr.zero, dtype=np.float64)
    acoo = a0.adj.tocoo()
    bcoo = b0.adj.tocoo()
    a_keep = _host_entry_keep(a0, acoo, asels)
    b_keep = _host_entry_keep(b0, bcoo, bsels)

    if sr.name == "plus_times":
        da = acoo.data if a_keep is None else np.where(a_keep, acoo.data, 0.0)
        db = bcoo.data if b_keep is None else np.where(b_keep, bcoo.data, 0.0)
        am = sp.csr_matrix((da, (acoo.row, acoo.col)),
                           shape=a0.adj.shape)[:, ia]
        bm = sp.csr_matrix((db, (bcoo.row, bcoo.col)),
                           shape=b0.adj.shape)[ib, :]
        if axis is None:
            out = Assoc._from_parts(a0.row, b0.col, 1.0, (am @ bm).tocoo())
            out._drop_zeros_and_condense()
            return out
        if axis == 1:
            return np.asarray(am @ (bm @ np.ones(bm.shape[1]))).ravel()
        return np.asarray((np.ones(am.shape[0]) @ am) @ bm).ravel()

    amap = np.full(len(a0.col), -1, dtype=np.int64)
    amap[ia] = np.arange(len(inner))
    bmap = np.full(len(b0.row), -1, dtype=np.int64)
    bmap[ib] = np.arange(len(inner))
    ak, bk = amap[acoo.col], bmap[bcoo.row]
    am_, bm_ = ak >= 0, bk >= 0
    if a_keep is not None:
        am_ &= a_keep
    if b_keep is not None:
        bm_ &= b_keep
    a_row, a_k, a_val = acoo.row[am_], ak[am_], acoo.data[am_]
    b_k, b_col, b_val = bk[bm_], bcoo.col[bm_], bcoo.data[bm_]
    order = np.lexsort((b_col, b_k))
    if axis is None:
        r, c, v = spgemm_np(a_row, a_k, a_val,
                            b_k[order], b_col[order], b_val[order],
                            sr.mul_np, sr.add_np)
        keep = v != sr.zero
        return Assoc._assemble(a0.row, b0.col, r[keep], c[keep], v[keep])
    return spgemm_reduce_np(a_row, a_k, a_val,
                            b_k[order], b_col[order], b_val[order],
                            sr.mul_np, sr.add_np, sr.zero, axis, n_out)


# ---------------------------------------------------------------------------
# Fused select→matmul, device layer (keeps flow into the spgemm plan)
# ---------------------------------------------------------------------------

def _tensor_entry_keep(t, sels) -> Optional[np.ndarray]:
    if sels is None:
        return None
    rc = compile_selector(sels[0], t.row_space)
    cc = compile_selector(sels[1], t.col_space)
    na = int(t.nnz)
    box = _range_box(rc, cc)
    if box is not None:
        return coo_range_keep(t.rows[:na], t.cols[:na], box).cpu().numpy()
    rows = t.rows[:na].cpu().numpy().astype(np.int64)
    cols = t.cols[:na].cpu().numpy().astype(np.int64)
    return _entry_keep(rc, cc, rows, cols)


def _device_fused_matmul(a, asels, b, bsels, sr, axis=None):
    from . import spgemm
    a_keep = _tensor_entry_keep(a, asels)
    b_keep = _tensor_entry_keep(b, bsels)
    if axis is None:
        return spgemm.matmul(a, b, sr, a_keep=a_keep, b_keep=b_keep)
    return spgemm.matmul_reduce(a, b, axis, sr,
                                a_keep=a_keep, b_keep=b_keep)


# ---------------------------------------------------------------------------
# Fused select→matmul, dist layer (shard-local masking)
# ---------------------------------------------------------------------------

def _dist_fused_matmul(a, asels, b, bsels, sr, axis=None):
    """``A[asel] ⊗.⊕ B[bsel]`` (``axis``: its fused reduce) on the dist
    layer: each rank sentinel-masks its own A shard's deselected rows IN
    PLACE (the expand-join and the pair-list planner skip SENT entries, so
    the sliced A never exists as a compacted array), and B's deselected
    entries are ⊗-annihilated — value → semiring zero — rather than
    removed: the rank arrays stay sorted for the join, and zero products
    drop in the canonical merge (every registered semiring's zero
    annihilates ⊗)."""
    from .assoc_tensor import AssocTensor
    from .dist_assoc import DistAssoc

    sr = get_semiring(sr)
    masked = DistAssoc(_dist_masked_local(a, asels), a.mesh,
                       row_bounds=a.row_bounds)
    bt = a._as_replicated_operand(b)
    bt = bt if bt.numeric else bt.logical()
    if bsels is not None:
        rc = compile_selector(bsels[0], bt.row_space)
        cc = compile_selector(bsels[1], bt.col_space)
        rows_h = bt.rows.cpu().numpy().astype(np.int64)
        cols_h = bt.cols.cpu().numpy().astype(np.int64)
        keep = _entry_keep(rc, cc, rows_h, cols_h)
        if keep is not None:
            keep &= rows_h != int(SENT)
            zero = torch.tensor(sr.zero, dtype=bt.vals.dtype,
                                device=bt.device)
            bt = AssocTensor(bt.rows, bt.cols,
                             torch.where(torch.from_numpy(keep).to(
                                 bt.device), bt.vals, zero),
                             bt.nnz, bt.row_space, bt.col_space, None)
    if axis is None:
        return masked.matmul(bt, sr)
    return masked.matmul_reduce(bt, axis, sr)


# ---------------------------------------------------------------------------
# Fused select→ewise-add (the pushdown's (A ⊕ B)[sel] → A[sel] ⊕ B[sel]
# shape): the slices never materialize — compiled keep masks filter each
# operand's entries inside the ONE canonical merge, exactly how matmul
# operands fuse.  Saves a compaction per sliced operand.
# ---------------------------------------------------------------------------

def _fused_select_add(a, asels, b, bsels, sr):
    sr = get_semiring(sr)
    layer = _layer(a)
    numeric = (a.local.numeric and b.local.numeric if layer == "dist"
               else a.numeric and b.numeric)
    if not numeric:
        # string ⊕ concatenates (order-sensitive, no zero to drop): keep
        # the materializing path rather than re-deriving its semantics
        aa = a._select_eager(asels) if asels is not None else a
        bb = b._select_eager(bsels) if bsels is not None else b
        return aa.add(bb, sr)
    _bump("fused_select_ewise")
    if layer == "host":
        return _host_fused_select_add(a, asels, b, bsels, sr)
    if layer == "device":
        return _device_fused_select_add(a, asels, b, bsels, sr)
    return _dist_fused_select_add(a, asels, b, bsels, sr)


def _host_fused_select_add(a, asels, b, bsels, sr):
    from .assoc import Assoc

    acoo = a.adj.tocoo()
    bcoo = b.adj.tocoo()
    a_keep = _host_entry_keep(a, acoo, asels)
    b_keep = _host_entry_keep(b, bcoo, bsels)
    row_u, _, _ = sorted_union(a.row, b.row)
    col_u, _, _ = sorted_union(a.col, b.col)
    rs, cs, vs = [], [], []
    for t, coo, keep in ((a, acoo, a_keep), (b, bcoo, b_keep)):
        rmap = np.searchsorted(row_u, t.row)
        cmap = np.searchsorted(col_u, t.col)
        er, ec, ev = coo.row, coo.col, coo.data
        if keep is not None:
            er, ec, ev = er[keep], ec[keep], ev[keep]
        rs.append(rmap[er])
        cs.append(cmap[ec])
        vs.append(ev)
    if not sum(len(x) for x in rs):
        return Assoc()
    r, c, v = canonicalize_np(np.concatenate(rs), np.concatenate(cs),
                              np.concatenate(vs), combine=sr.add_np)
    keep = v != sr.zero
    return Assoc._assemble(row_u, col_u, r[keep], c[keep], v[keep])


def _masked_rows(t, sels) -> torch.Tensor:
    """Rows array with deselected entries sentinel-masked in place (the
    canonical merge skips SENT — no compact, no per-operand sort)."""
    keep = _tensor_entry_keep(t, sels)
    if keep is None:
        return t.rows
    full = np.zeros(t.rows.shape[0], bool)
    full[:len(keep)] = keep
    return torch.where(torch.from_numpy(full).to(t.device), t.rows, SENT)


def _device_fused_select_add(a, asels, b, bsels, sr):
    from .assoc_tensor import AssocTensor

    rs_space, ra_m, rb_m = a.row_space.union(b.row_space)
    cs_space, ca_m, cb_m = a.col_space.union(b.col_space)

    def remap(t, sels, rm, cm):
        rows = _masked_rows(t, sels)
        ok = rows != SENT
        rmj = _upload_map(rm, t.device)
        cmj = _upload_map(cm, t.device)
        rr = torch.where(ok, rmj[rows.clamp(0, rmj.shape[0] - 1).long()], SENT)
        cc = torch.where(ok, cmj[t.cols.clamp(0, cmj.shape[0] - 1).long()],
                         SENT)
        return rr, cc, t.vals
    ar, ac, av = remap(a, asels, ra_m, ca_m)
    br, bc, bv = remap(b, bsels, rb_m, cb_m)
    rows = torch.cat([ar, br])
    cols = torch.cat([ac, bc])
    vals = torch.cat([av, bv])
    r, c, v, nnz = dedup_sorted_coo(rows, cols, vals, sr.add, zero=sr.zero)
    return AssocTensor(r, c, v, nnz, rs_space, cs_space, a.val_space)


def _dist_masked_local(d, sels):
    """This rank's shard with the deselected entries' rows sentinel-masked:
    the keep mask comes from the rank's own entries (a rank box's from the
    range-mask kernel, on the shard's device)."""
    from .assoc_tensor import AssocTensor

    loc = d.local
    if sels is None:
        return loc
    rc = compile_selector(sels[0], loc.row_space)
    cc = compile_selector(sels[1], loc.col_space)
    box = _range_box(rc, cc)
    if box is not None:   # SENT rows lie outside every box
        keep_dev = coo_range_keep(loc.rows, loc.cols, box)
        return AssocTensor(torch.where(keep_dev, loc.rows, SENT), loc.cols,
                           loc.vals, loc.nnz, loc.row_space, loc.col_space,
                           loc.val_space)
    rows_h = loc.rows.cpu().numpy().astype(np.int64)
    cols_h = loc.cols.cpu().numpy().astype(np.int64)
    keep = _entry_keep(rc, cc, rows_h, cols_h)
    if keep is None:
        return loc
    keep &= rows_h != int(SENT)
    keep_dev = torch.from_numpy(keep).to(loc.device)
    return AssocTensor(torch.where(keep_dev, loc.rows, SENT), loc.cols,
                       loc.vals, loc.nnz, loc.row_space, loc.col_space,
                       loc.val_space)


def _dist_fused_select_add(a, asels, b, bsels, sr):
    from .dist_assoc import DistAssoc, _ewise_prog

    out = _ewise_prog(_dist_masked_local(a, asels),
                      _dist_masked_local(b, bsels), sr, "add")
    return DistAssoc(out, a.mesh, row_bounds=a.row_bounds)


# ---------------------------------------------------------------------------
# Shared axis reductions (the one reduce path: eager sum/reduce_rows and
# the Reduce node all land here — dtype/zero rules from the combine helpers)
# ---------------------------------------------------------------------------

def host_axis_reduce(a, axis: Optional[int], semiring=PLUS_TIMES):
    """⊕-reduce a host Assoc: ``axis=1`` → float64 vector over ``a.row``,
    ``axis=0`` → vector over ``a.col``, ``None`` → scalar.  ``(+,×)``
    keeps the scipy fast path (bit-identical to the historical
    ``Assoc.sum``); other semirings run one ``add_np`` scatter — the host
    mirror of :func:`~repro.core.semiring.scatter_combine`."""
    sr = get_semiring(semiring)
    aa = a if a.numeric else a.logical()
    if axis is None:
        if aa.nnz() == 0:
            return float(sr.zero)
        if sr.name == "plus_times":
            return float(aa.adj.sum())
        return float(sr.add_np.reduce(aa.adj.tocoo().data))
    if axis not in (0, 1):
        raise ValueError(f"axis must be None, 0 or 1, got {axis!r}")
    if sr.name == "plus_times":
        return np.asarray(aa.adj.sum(axis=axis), dtype=np.float64).ravel()
    coo = aa.adj.tocoo()
    n_out = len(aa.row) if axis == 1 else len(aa.col)
    out = np.full(n_out, sr.zero, dtype=np.float64)
    sr.add_np.at(out, coo.row if axis == 1 else coo.col, coo.data)
    return out


def device_axis_reduce(t, axis: Optional[int], semiring=PLUS_TIMES):
    """⊕-reduce a device AssocTensor with one ``scatter_combine``:
    ``axis=1`` → vector over the row keyspace, ``axis=0`` → over the col
    keyspace, ``None`` → scalar ⊕ over every stored entry."""
    sr = get_semiring(semiring)
    ok = t.valid_mask()
    if axis is None:
        return sr.add_reduce(torch.where(ok, t.vals, sr.zero))
    if axis not in (0, 1):
        raise ValueError(f"axis must be None, 0 or 1, got {axis!r}")
    n_out = len(t.row_space) if axis == 1 else len(t.col_space)
    keys = t.rows if axis == 1 else t.cols
    vec = torch.full((n_out,), sr.zero, dtype=t.vals.dtype, device=t.device)
    return scatter_combine(vec, torch.where(ok, keys, n_out),
                           torch.where(ok, t.vals, sr.zero), sr)


def _axis_reduce(arr, axis: Optional[int], sr):
    layer = _layer(arr)
    if layer == "host":
        return host_axis_reduce(arr, axis, sr)
    if layer == "device":
        return device_axis_reduce(arr, axis, sr)
    if axis == 0:
        return arr.col_reduce(sr)
    if axis == 1:
        return arr.row_reduce(sr)
    srr = get_semiring(sr)
    vec = arr.col_reduce(sr)
    if vec.shape[0] == 0:
        return torch.tensor(srr.zero, dtype=torch.float32, device=vec.device)
    return srr.add_reduce(vec)


# ---------------------------------------------------------------------------
# Fused ⊕-chain reductions (Reduce pushed through EwiseAdd: every term's
# entries scatter straight into the output vector — the ⊕-merged array is
# never materialized, so its concat + canonicalize sort never runs)
# ---------------------------------------------------------------------------

def _reduce_add_n(terms, axis, sr, ewise_sr):
    sr = get_semiring(sr)
    ewise_sr = get_semiring(ewise_sr)
    layers = {_layer(t) for t in terms}
    if len(layers) != 1:
        raise TypeError(f"⊕ chain mixes layers: {sorted(layers)}")
    layer = layers.pop()
    numeric = all((t.local.numeric if layer == "dist" else t.numeric)
                  for t in terms)
    if not numeric:
        # string ⊕ concatenates before logical() flattens — per-entry
        # scatter would count overlaps twice; materialize the chain
        return _axis_reduce(_add_n(terms, ewise_sr), axis, sr)
    if layer == "host":
        return _host_reduce_add_n(terms, axis, sr)
    if layer == "device":
        return _device_reduce_add_n(terms, axis, sr)
    return _dist_reduce_add_n(terms, axis, sr)


def _host_reduce_add_n(terms, axis, sr):
    live = [t for t in terms if t.nnz()]
    if not live:
        return np.full(0, sr.zero, dtype=np.float64)
    key_u = live[0].row if axis == 1 else live[0].col
    for t in live[1:]:
        key_u, _, _ = sorted_union(key_u, t.row if axis == 1 else t.col)
    out = np.full(len(key_u), sr.zero, dtype=np.float64)
    for t in live:
        coo = t.adj.tocoo()
        keys = t.row if axis == 1 else t.col
        kmap = np.searchsorted(key_u, keys)
        sr.add_np.at(out, kmap[coo.row if axis == 1 else coo.col], coo.data)
    return out


def _device_reduce_add_n(terms, axis, sr):
    rs_space, cs_space = terms[0].row_space, terms[0].col_space
    for t in terms[1:]:
        rs_space, _, _ = rs_space.union(t.row_space)
        cs_space, _, _ = cs_space.union(t.col_space)
    out_space = rs_space if axis == 1 else cs_space
    n_out = max(len(out_space), 0)
    dt = terms[0].vals.dtype
    for t in terms[1:]:
        dt = torch.promote_types(dt, t.vals.dtype)
    vec = torch.full((n_out,), sr.zero, dtype=dt, device=terms[0].device)
    for t in terms:
        ok = t.valid_mask()
        space = t.row_space if axis == 1 else t.col_space
        keys = t.rows if axis == 1 else t.cols
        if space != out_space:
            kmap = np.searchsorted(out_space.keys, space.keys).astype(np.int32)
            if kmap.shape[0]:
                kmap = _upload_map(kmap, t.device)
                keys = kmap[keys.clamp(0, kmap.shape[0] - 1).long()]
        vec = scatter_combine(vec, torch.where(ok, keys, n_out),
                              torch.where(ok, t.vals, sr.zero), sr)
    return vec


def _dist_reduce_add_n(terms, axis, sr):
    from .dist_assoc import _reduce_add_n_prog

    d0 = terms[0]
    n_out = len(d0.local.row_space if axis == 1 else d0.local.col_space)
    return _reduce_add_n_prog(d0.mesh, sr, axis, n_out,
                              [t.local for t in terms])


# ---------------------------------------------------------------------------
# Fused n-ary ⊕ chains (one canonicalize pass)
# ---------------------------------------------------------------------------

def _add_n(terms, sr):
    sr = get_semiring(sr)
    layers = {_layer(t) for t in terms}
    if len(layers) != 1:
        raise TypeError(f"⊕ chain mixes layers: {sorted(layers)}")
    layer = layers.pop()
    if layer == "host":
        return _host_add_n(terms, sr)
    if layer == "device":
        return _device_add_n(terms, sr)
    return _dist_add_n(terms, sr)


def _host_add_n(terms, sr):
    from .assoc import Assoc, is_string_array

    live = [t for t in terms if t.nnz()]
    if not live:
        return Assoc()
    if len(live) == 1:
        return live[0].copy()
    if any(not t.numeric for t in live):
        # string ⊕ is order-sensitive concatenation: left fold pairwise
        out = live[0]
        for t in live[1:]:
            out = out.add(t, sr)
        return out
    str_rows = is_string_array(live[0].row)
    str_cols = is_string_array(live[0].col)
    if any(is_string_array(t.row) != str_rows
           or is_string_array(t.col) != str_cols for t in live):
        raise TypeError("cannot mix string and numeric key sets")
    row_u, col_u = live[0].row, live[0].col
    for t in live[1:]:
        row_u, _, _ = sorted_union(row_u, t.row)
        col_u, _, _ = sorted_union(col_u, t.col)
    rs, cs, vs = [], [], []
    for t in live:
        coo = t.adj.tocoo()
        rmap = np.searchsorted(row_u, t.row)
        cmap = np.searchsorted(col_u, t.col)
        rs.append(rmap[coo.row])
        cs.append(cmap[coo.col])
        vs.append(coo.data)
    r, c, v = canonicalize_np(np.concatenate(rs), np.concatenate(cs),
                              np.concatenate(vs), combine=sr.add_np)
    keep = v != sr.zero
    return Assoc._assemble(row_u, col_u, r[keep], c[keep], v[keep])


def _device_add_n(terms, sr):
    from .assoc_tensor import AssocTensor

    rs_space, cs_space = terms[0].row_space, terms[0].col_space
    for t in terms[1:]:
        rs_space, _, _ = rs_space.union(t.row_space)
        cs_space, _, _ = cs_space.union(t.col_space)
    aligned = []
    for t in terms:
        if t.row_space == rs_space and t.col_space == cs_space:
            aligned.append(t)
            continue
        rm = np.searchsorted(rs_space.keys, t.row_space.keys).astype(np.int32)
        cm = np.searchsorted(cs_space.keys, t.col_space.keys).astype(np.int32)
        aligned.append(t.reranked(rs_space, cs_space, rm, cm))
    rows = torch.cat([t.rows for t in aligned])
    cols = torch.cat([t.cols for t in aligned])
    vals = torch.cat([t.vals for t in aligned])
    r, c, v, nnz = dedup_sorted_coo(rows, cols, vals, sr.add, zero=sr.zero)
    return AssocTensor(r, c, v, nnz, rs_space, cs_space,
                       aligned[0].val_space)


def _dist_add_n(terms, sr):
    from .dist_assoc import DistAssoc, _add_n_prog

    d0 = terms[0]
    return DistAssoc(_add_n_prog([t.local for t in terms], sr), d0.mesh,
                     row_bounds=d0.row_bounds)
