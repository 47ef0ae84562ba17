"""repro_torch.core — D4M associative arrays on torch.

* ``coo``          — the canonical COO/semiring triple-store core
                     (host ``canonicalize_np`` / device ``dedup_sorted_coo``).
* ``Assoc``        — paper-faithful host implementation (numpy/scipy).
* ``AssocTensor``  — device implementation (padded COO on torch tensors,
                     semirings, hand-written CUDA kernels on the card).
* ``KeySpace``     — host key dictionaries backing device rank tensors.
* ``Semiring``     — the value algebras (⊕, ⊗, 0, 1).
* ``expr``/``plan`` — lazy expression graphs + the planner/executor behind
                     them (``A.lazy()[sel] @ B.lazy()[sel] … .collect()``).

Telemetry counters (and their reset helpers) are exported together so
benchmarks and tests can assert a fast path actually fired:
``CACHE_STATS`` (selector compilation), ``UNION_STATS`` (keyspace-union
memoization), ``DISPATCH_STATS`` (selection execution paths) and
``PLAN_STATS`` (expression hash-consing + planner rewrites).
"""
from .assoc import Assoc
from .assoc_tensor import AssocTensor, DISPATCH_STATS
from .coo import (aggregate_runs, canonicalize_np, dedup_sorted_coo,
                  intersect_pairs_np, linearize_pairs_np, spgemm_np)
from .expr import (EwiseAdd, EwiseMul, LazyExpr, MatMul, Reduce, Select,
                   Source, Transpose, lazy)
from .keyspace import KeySpace, UNION_STATS, clear_union_cache
from .plan import PLAN_STATS, clear_plan_cache, reset_plan_stats
from .select import (All, CACHE_STATS, Keys, Mask, Match, Positions, Range,
                     Selector, StartsWith, Where, as_selector,
                     clear_compile_cache, compile_selector, reset_cache_stats)
from .semiring import (AND_OR, MAX_MIN, MAX_PLUS, MAX_TIMES, MIN_PLUS,
                       PLUS_TIMES, REGISTRY, STRING, Semiring, get_semiring,
                       scatter_combine)
from .spgemm import matmul_reduce, plan_matmul
from .sorted_ops import (INT_SENTINEL, sorted_intersect,
                         sorted_intersect_padded, sorted_union,
                         sorted_union_padded)


def reset_all_stats():
    """Zero every telemetry counter in one call.

    Covers ``UNION_STATS`` (and drops the keyspace-union cache),
    ``CACHE_STATS`` (selector compilation — counters only; compiled
    selectors stay warm), ``DISPATCH_STATS`` (selection execution paths)
    and ``PLAN_STATS`` (and drops the plan cache).  Kernel launch counts
    are separate: :func:`repro_torch.kernels.reset_launch_counts`.
    """
    clear_union_cache()
    reset_cache_stats()
    for k in DISPATCH_STATS:
        DISPATCH_STATS[k] = 0
    reset_plan_stats()


__all__ = [
    "Assoc", "AssocTensor", "KeySpace", "Semiring", "get_semiring",
    "REGISTRY", "PLUS_TIMES", "MAX_PLUS", "MIN_PLUS", "MAX_MIN", "MAX_TIMES",
    "AND_OR", "STRING", "INT_SENTINEL", "sorted_union", "sorted_intersect",
    "sorted_union_padded", "sorted_intersect_padded",
    "aggregate_runs", "canonicalize_np", "dedup_sorted_coo",
    "intersect_pairs_np", "linearize_pairs_np", "spgemm_np",
    "matmul_reduce", "plan_matmul", "scatter_combine",
    "Selector", "Keys", "Range", "StartsWith", "Match", "Where", "Mask",
    "Positions", "All", "as_selector", "compile_selector",
    # lazy expressions + planner
    "LazyExpr", "Source", "Select", "EwiseAdd", "EwiseMul", "MatMul",
    "Reduce", "Transpose", "lazy",
    # telemetry counters + reset helpers
    "reset_all_stats",
    "PLAN_STATS", "reset_plan_stats", "clear_plan_cache",
    "CACHE_STATS", "clear_compile_cache", "reset_cache_stats",
    "UNION_STATS", "clear_union_cache",
    "DISPATCH_STATS",
]
