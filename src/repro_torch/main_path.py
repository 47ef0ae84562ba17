"""The device layer's main path, driven end to end and checked on the host.

Two workloads (:mod:`repro_torch.configs.d4m_bench`):

* **clustered** (Graphulo-style communities, values 1.0) — build A and B
  with ``from_triples``, select a row ``Range``, ``A + B``, ``A @ B`` (the
  planner picks ``bsr`` at the paper's sizes), ``A.sqout(reduce=1)`` (the
  fused pair-list reduce) and the lazy pipeline
  ``(A.lazy()[sel, :] @ B.lazy()).sum(axis=1).collect()``;
* **uniform** (the paper's own workload, values 1..100) —
  ``A.matmul(B)`` under ``PLUS_TIMES`` and ``MIN_PLUS``, ``A.sqout(reduce=1)``,
  ``A.matmul_reduce(B, axis=0)`` and the lazy pipeline (the planner picks
  ``dense`` for the first four at the paper's n=12, so the fused reduces
  run the block-masked ``bsr_spgemm_reduce`` kernel);
* **ingest** (the uniform workload as a stream) — an
  :class:`~repro_torch.ingest.IngestTable` over A takes B's triples in
  batches; snapshots (merge-on-read through the ``rank_count`` kernel)
  halfway and at the end, a row ``Range`` selection on the snapshot,
  ``compact()``, one more batch and a snapshot, for ``aggregate="sum"``
  and ``"max"``; and the concat fallback (:func:`drive_ingest_fallback`)
  over an array whose keyspace is too large to linearize into int32;
* **dist** (the clustered arrays on a mesh, :func:`build_dist` /
  :func:`drive_dist`) — ``DistAssoc`` A and B on their union keyspaces:
  the row ``Range`` selection, ``A + B``, ``A.mul(B)``, a scalar
  assignment, ``col_reduce``/``row_reduce`` under ``PLUS_TIMES`` and
  ``MAX_PLUS``, ``col_degree``, ``matmul_dense_vec`` of a ones vector, the
  lazy select-⊕ and ⊕-reduce pipelines, ``gather_replicated`` and
  ``to_assoc`` — each beside the same operation on the device
  ``AssocTensor``s, with the collectives and ``range_mask`` launches each
  dist operation made; and the ingest workload over a ``DistAssoc`` base
  (``build_ingest(..., mesh=)``);
* **dist product** (:func:`drive_dist_product`) — the clustered and the
  uniform arrays as ``DistAssoc``s: ``A @ B`` (the cost model's strategy;
  at one rank replicate, whose tiled compute runs ``bsr_pairlist``), the
  forced ``coo``, ``all_to_all`` and ``2d`` strategies,
  ``matmul_reduce`` under replicate and all-to-all, ``sqout(reduce=1)``,
  ``sqin()`` and ``sqin(reduce=1)`` (the device layer's product on the
  gathered array), the lazy select→product and select→product→sum, and
  the uniform ``A.matmul(B)`` under ``PLUS_TIMES`` and ``MIN_PLUS`` — with
  the collectives, strategy and kernel launches of each;
* **serve** (:func:`build_serve` / :func:`drive_serve`) — the arrays
  above, registered as resident tables of the query server
  (:mod:`repro_torch.serve`) and queried by client threads over loopback
  HTTP in six mixes (:data:`SERVE_COUNTS`): hot, cold, product, dense,
  ingest (``POST /ingest`` then a read) and dist, with each query also
  collected in process.

:func:`check_clustered` / :func:`check_uniform` / :func:`check_ingest` /
:func:`check_dist` / :func:`check_dist_product` / :func:`check_serve`
hold the results against the host ``Assoc``
(numpy/scipy) built from the same raw triples — a check that shares no code with the torch device path.  ``full=True`` compares
every result entry by entry; otherwise counts, checksums and the reduced
vectors are compared.  ``chip_smoke.py`` runs this on the card; the tests
run it on the CPU.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .analysis.contracts import CONTRACT_REGISTRY
from .configs.d4m_bench import make_clustered, make_dataset
from .core import (MAX_PLUS, MIN_PLUS, PLAN_STATS, PLUS_TIMES, Assoc,
                   AssocTensor, DistAssoc, Keys, KeySpace, Range, spgemm)
from .core.collectives import (BROADCAST_STATS, COLLECTIVE_STATS,
                               collective_count, prologue_count)
from .core.plan import host_axis_reduce
from .ingest import IngestTable
from .kernels import LAUNCHES

__all__ = ["build_clustered", "build_uniform", "build_ingest", "build_dist",
           "build_serve", "drive_clustered", "drive_uniform", "drive_ingest",
           "drive_dist", "drive_ingest_fallback", "drive_dist_product",
           "drive_serve", "check_clustered", "check_uniform", "check_ingest",
           "check_ingest_fallback", "check_dist", "check_dist_ingest",
           "check_dist_product", "check_serve", "row_range",
           "DIST_COLLECTIVES", "DIST_PRODUCT_COLLECTIVES", "SERVE_COUNTS",
           "SERVE_MIX_KERNELS"]

INGEST_AGGREGATES = ("sum", "max")
INGEST_BATCHES = 16


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Clock:
    """Wall-clock seconds per named step, each ended by a device sync."""

    def __init__(self, device):
        self.device = device
        self.seconds: Dict[str, float] = {}

    def __call__(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(self.device)
        self.seconds[name] = time.perf_counter() - t0
        return out


def build_clustered(n: int, device) -> dict:
    """Raw clustered triples and the two device arrays built from them."""
    rows, cols, rows2, cols2 = make_clustered(n)
    ones = np.ones(len(rows))
    cap = int(np.ceil(len(rows) / 8) * 8)
    clock = _Clock(device)
    a = clock("from_triples", AssocTensor.from_triples, rows, cols, ones,
              capacity=cap, device=device)
    b = AssocTensor.from_triples(rows2, cols2, ones, capacity=cap,
                                 device=device)
    return {"raw": (rows, cols, rows2, cols2), "A": a, "B": b,
            "seconds": clock.seconds}


def build_uniform(n: int, device) -> dict:
    """The paper's uniform triples (values 1..100, so no value is the
    unstored 0) and the two device arrays."""
    d = make_dataset(n)
    vals = d["num_vals"] + 1.0
    a = AssocTensor.from_triples(d["rows"], d["cols"], vals, device=device)
    b = AssocTensor.from_triples(d["rows2"], d["cols2"], vals, device=device)
    return {"raw": (d["rows"], d["cols"], d["rows2"], d["cols2"], vals),
            "A": a, "B": b}


def row_range(a) -> Range:
    """The row selection of the main path: the second quarter of A's row
    keys (a contiguous rank box, so it runs the range kernel); ``a`` is an
    ``AssocTensor`` or a ``DistAssoc``."""
    keys = getattr(a, "local", a).row_space.keys
    return Range(keys[len(keys) // 4], keys[len(keys) // 2])


def drive_clustered(a: AssocTensor, b: AssocTensor) -> dict:
    """Select, ⊕, ⊗.⊕, fused sqout reduce and the lazy fused pipeline."""
    sel = row_range(a)
    clock = _Clock(a.device)
    out = {
        "select": clock("select", lambda: a[sel, :]),
        "add": clock("add", lambda: a + b),
        "matmul": clock("matmul", lambda: a @ b),
        "sqout_reduce": clock("sqout_reduce", lambda: a.sqout(reduce=1)),
        "pipeline": clock("pipeline", lambda: (
            a.lazy()[sel, :] @ b.lazy()).sum(axis=1).collect()),
    }
    out["selector"] = sel
    out["seconds"] = clock.seconds
    return out


def drive_uniform(a: AssocTensor, b: AssocTensor) -> dict:
    """Dense ⊗.⊕ under two semirings, the fused reduces on both axes and
    the lazy fused pipeline."""
    sel = row_range(a)
    clock = _Clock(a.device)
    out = {name: clock(name, a.matmul, b, sr)
           for name, sr in (("plus_times", PLUS_TIMES),
                            ("min_plus", MIN_PLUS))}
    out["sqout_reduce"] = clock("sqout_reduce", lambda: a.sqout(reduce=1))
    out["matmul_reduce0"] = clock("matmul_reduce0",
                                  lambda: a.matmul_reduce(b, axis=0))
    out["pipeline"] = clock("pipeline", lambda: (
        a.lazy()[sel, :] @ b.lazy()).sum(axis=1).collect())
    out["selector"] = sel
    out["seconds"] = clock.seconds
    return out


def build_ingest(n: int, device, mesh=None) -> dict:
    """The uniform triples at size n (values 1..100) and one base array
    over A's triples per ingest aggregate (built with that aggregate, so
    base ⊕ delta equals a one-shot build over all triples): an
    ``AssocTensor``, or with ``mesh`` a ``DistAssoc``."""
    d = make_dataset(n)
    vals = d["num_vals"] + 1.0
    if mesh is None:
        bases = {agg: AssocTensor.from_triples(d["rows"], d["cols"], vals,
                                               aggregate=agg, device=device)
                 for agg in INGEST_AGGREGATES}
    else:
        bases = {agg: DistAssoc.from_triples(d["rows"], d["cols"], vals, mesh,
                                             aggregate=agg, device=device)
                 for agg in INGEST_AGGREGATES}
    return {"raw": (d["rows"], d["cols"], d["rows2"], d["cols2"], vals),
            "bases": bases}


def drive_ingest(built: dict) -> dict:
    """Stream B's triples into an :class:`IngestTable` over each base in
    :data:`INGEST_BATCHES` equal batches; snapshot halfway and at the end,
    select a row ``Range`` on the snapshot, compact, insert A's first
    batch again (every key collides with the base) and snapshot once
    more."""
    rows, cols, rows2, cols2, vals = built["raw"]
    batches = INGEST_BATCHES
    size = len(rows2) // batches
    out = {"batch": size, "batches": batches, "per_aggregate": {}}
    for agg, base in built["bases"].items():
        clock = _Clock(base.device)
        table = IngestTable(base, aggregate=agg)
        r: Dict[str, object] = {}
        for k in range(batches):
            part = slice(k * size, (k + 1) * size)
            clock(f"insert{k}", table.insert, rows2[part], cols2[part],
                  vals[part])
            if k + 1 == batches // 2:
                r["snap_half"] = clock("snapshot_half", table.snapshot)
        r["snap_full"] = clock("snapshot_full", table.snapshot)
        r["selector"] = row_range(r["snap_full"])
        r["select"] = clock("select", lambda: r["snap_full"][r["selector"], :])
        r["compact"] = clock("compact", table.compact)
        table.insert(rows[:size], cols[:size], vals[:size])
        r["snap_after"] = clock("snapshot_after", table.snapshot)
        r["stats"] = dict(table.stats)
        r["version"] = table.version
        r["seconds"] = clock.seconds
        out["per_aggregate"][agg] = r
    return out


def drive_ingest_fallback(a: AssocTensor, raw, n_insert: int = 65536
                          ) -> dict:
    """Insert B's first ``n_insert`` triples (values 1.0) into an
    ``aggregate="sum"`` table over ``a`` and snapshot: with
    nrows·ncols ≥ 2³¹−1 the merge takes the concat fallback."""
    _, _, rows2, cols2 = raw
    clock = _Clock(a.device)
    table = IngestTable(a, aggregate="sum")
    table.insert(rows2[:n_insert], cols2[:n_insert], np.ones(n_insert))
    snap = clock("snapshot", table.snapshot)
    return {"snapshot": snap, "n_insert": n_insert,
            "stats": dict(table.stats), "seconds": clock.seconds}


def _declared(name: str) -> int:
    """The program collectives the ``@contract`` of entry ``name`` declares
    (the JAX package's declaration, checked by ``repro_torch.analysis``)."""
    return CONTRACT_REGISTRY[name].collectives


def _by_family(**counts) -> Dict[str, int]:
    return {k: v for k, v in counts.items() if v}


# gather_replicated and to_assoc: one all_gather (no @contract, as in the
# JAX package)
_GATHER = 1

# the collectives each dist operation of drive_dist makes: the entries'
# @contract declarations (a lazy pipeline: those of the entries it fuses)
_SELECT, _ADD = _declared("DistAssoc.__getitem__"), _declared("DistAssoc.add")
DIST_COLLECTIVES = {
    "select": _SELECT, "add": _ADD, "mul": _declared("DistAssoc.mul"),
    "setitem": _declared("DistAssoc.__setitem__"),
    "lazy_select_add": 2 * _SELECT + _ADD,
    **{f"{op} {sr}": _declared(f"DistAssoc.{op}")
       for op in ("col_reduce", "row_reduce")
       for sr in ("plus_times", "max_plus")},
    "col_degree": _declared("DistAssoc.col_degree"),
    "matmul_dense_vec": _declared("DistAssoc.matmul_dense_vec"),
    "lazy_add_sum": _ADD + _declared("DistAssoc.row_reduce"),
    "gather_replicated": _GATHER, "to_assoc": _GATHER,
}


def build_dist(raw, mesh, device) -> dict:
    """A and B as ``DistAssoc``s on ``mesh``, both on the union of their
    keyspaces (element-wise dist operands share their keyspaces and row
    partition): the clustered raw triples (values 1.0) or the uniform ones
    (``build_uniform``'s ``raw``, with its values)."""
    rows, cols, rows2, cols2 = raw[:4]
    vals = raw[4] if len(raw) > 4 else 1.0
    rs = KeySpace(np.concatenate([rows, rows2]))
    cs = KeySpace(np.concatenate([cols, cols2]))
    clock = _Clock(device)
    a = clock("dist from_triples", DistAssoc.from_triples, rows, cols, vals,
              mesh, row_space=rs, col_space=cs, device=device)
    b = DistAssoc.from_triples(rows2, cols2, vals, mesh, row_space=rs,
                               col_space=cs, device=device)
    return {"raw": raw, "A": a, "B": b, "seconds": clock.seconds}


def _setitem_copy(x, sel, value):
    """``x[sel, :] = value`` on a copy of ``x`` (either layer)."""
    if isinstance(x, DistAssoc):
        c = DistAssoc(x.local, x.mesh, row_bounds=x.row_bounds)
    else:
        c = AssocTensor(x.rows, x.cols, x.vals, x.nnz, x.row_space,
                        x.col_space, x.val_space)
    c[sel, :] = value
    return c


def drive_dist(a: DistAssoc, b: DistAssoc, ta: AssocTensor,
               tb: AssocTensor, sel) -> dict:
    """Every dist operation of the main path, each beside the same operation
    on the device arrays ``ta``/``tb`` (the same triples): results, wall
    seconds of both (each ended by a device sync; None where the device
    layer has no such operation: its result is ``ta`` itself), and the
    collectives and ``range_mask`` launches of the dist operation alone."""
    ones = torch.ones(len(a.local.col_space), device=a.device)
    steps = [
        ("select", lambda: a[sel, :], lambda: ta[sel, :]),
        ("add", lambda: a + b, lambda: ta + tb),
        ("mul", lambda: a.mul(b), lambda: ta.mul(tb)),
        ("setitem", lambda: _setitem_copy(a, sel, 2.0),
         lambda: _setitem_copy(ta, sel, 2.0)),
        ("lazy_select_add",
         lambda: (a.lazy()[sel, :] + b.lazy()[sel, :]).collect(),
         lambda: (ta.lazy()[sel, :] + tb.lazy()[sel, :]).collect()),
    ]
    for sr in (PLUS_TIMES, MAX_PLUS):
        steps += [
            (f"col_reduce {sr.name}", lambda sr=sr: a.col_reduce(sr),
             lambda sr=sr: ta.reduce_cols(sr)),
            (f"row_reduce {sr.name}", lambda sr=sr: a.row_reduce(sr),
             lambda sr=sr: ta.reduce_rows(sr))]
    steps += [
        ("col_degree", a.col_degree, lambda: ta.logical().reduce_cols()),
        # A ⊗.⊕ ones under (+, ×) is A's row sums
        ("matmul_dense_vec", lambda: a.matmul_dense_vec(ones),
         lambda: ta.reduce_rows(PLUS_TIMES)),
        ("lazy_add_sum", lambda: (a.lazy() + b.lazy()).sum(axis=1).collect(),
         lambda: (ta.lazy() + tb.lazy()).sum(axis=1).collect()),
        ("gather_replicated", a.gather_replicated, None),
        ("to_assoc", a.to_assoc, ta.to_assoc),
    ]
    out = {"dist": {}, "device": {}, "seconds": {}, "collectives": {},
           "range_mask": {}}
    for name, dist_fn, dev_fn in steps:
        n_coll, n_rm = collective_count(), LAUNCHES["range_mask"]
        t0 = time.perf_counter()
        out["dist"][name] = dist_fn()
        _sync(a.device)
        t1 = time.perf_counter()
        out["collectives"][name] = collective_count() - n_coll
        out["range_mask"][name] = LAUNCHES["range_mask"] - n_rm
        if dev_fn is None:
            out["device"][name], dev_s = ta, None
        else:
            out["device"][name] = dev_fn()
            _sync(ta.device)
            dev_s = time.perf_counter() - t1
        out["seconds"][name] = (t1 - t0, dev_s)
    out["selector"] = sel
    return out


# the program collectives each operation of drive_dist_product makes at one
# rank, by collective (no prologue collective runs at one rank): the
# @contract of each program, gather_replicated's all_gather where the
# operation gathers (sqout, sqin, and a resident B in the lazy product).
# sqin runs the device layer's product on the gathered array, as in the
# JAX package; the 2d grid of one rank is (1, 1): pc - 1 = 0 ring shifts
# (the dist.matmul_2d contract's 3 are pc - 1 of the probe's pc = 4 grid)
_MATMUL = _by_family(all_reduce=_declared("DistAssoc.matmul"))
_REDUCE = _declared("DistAssoc.matmul_reduce")
DIST_PRODUCT_COLLECTIVES = {
    "A @ B": _MATMUL, "coo": _MATMUL,
    "all_to_all": {"all_to_all": _declared("dist.matmul_all_to_all")},
    "2d": {},
    "matmul_reduce0 replicate": {"all_reduce": _REDUCE},
    "matmul_reduce0 all_to_all": {
        "all_reduce": _declared("dist.matmul_reduce_all_to_all")},
    "sqout_reduce": {"all_reduce": _declared("DistAssoc.sqout"),
                     "all_gather": _GATHER},
    "sqin": {"all_gather": _GATHER}, "sqin_reduce": {"all_gather": _GATHER},
    "lazy_select_matmul": {**_MATMUL, "all_gather": _GATHER},
    "pipeline": {"all_reduce": _REDUCE, "all_gather": _GATHER},
    "uniform plus_times": _MATMUL, "uniform min_plus": _MATMUL,
    "uniform sqin": {"all_gather": _GATHER},
    "uniform sqin_reduce": {"all_gather": _GATHER},
}


def drive_dist_product(dc: dict, du: dict, sel) -> dict:
    """Every dist product of the main path on the clustered (``dc``) and
    uniform (``du``) ``DistAssoc``s of :func:`build_dist`: wall seconds of
    each (ended by a device sync), its program collectives by name, its
    prologue collectives, the strategy the product ran (``PLAN_STATS``)
    and its kernel launches; then the stage split of ``A @ B``
    (``spgemm.stage_timing``) and its plan."""
    a, b = dc["A"], dc["B"]
    ua, ub = du["A"], du["B"]
    steps = [
        ("A @ B", lambda: a @ b),
        ("coo", lambda: a.matmul(b, impl="coo")),
        ("all_to_all", lambda: a.matmul(b, impl="all_to_all")),
        ("2d", lambda: a.matmul(b, impl="2d")),
        ("matmul_reduce0 replicate",
         lambda: a.matmul_reduce(b, axis=0, impl="replicate")),
        ("matmul_reduce0 all_to_all",
         lambda: a.matmul_reduce(b, axis=0, impl="all_to_all")),
        ("sqout_reduce", lambda: a.sqout(reduce=1)),
        ("sqin", a.sqin),
        ("sqin_reduce", lambda: a.sqin(reduce=1)),
        ("lazy_select_matmul",
         lambda: (a.lazy()[sel, :] @ b.lazy()).collect()),
        ("pipeline",
         lambda: (a.lazy()[sel, :] @ b.lazy()).sum(axis=1).collect()),
        ("uniform plus_times", lambda: ua.matmul(ub, PLUS_TIMES)),
        ("uniform min_plus", lambda: ua.matmul(ub, MIN_PLUS)),
        ("uniform sqin", ua.sqin),
        ("uniform sqin_reduce", lambda: ua.sqin(reduce=1)),
    ]
    out = {"dist": {}, "seconds": {}, "collectives": {}, "prologue": {},
           "strategy": {}, "launches": {}}
    strategies = ("replicate", "all_to_all", "2d")
    for name, fn in steps:
        coll = dict(COLLECTIVE_STATS)
        pro = prologue_count()
        plan = {k: PLAN_STATS[f"dist_{k}"] for k in strategies}
        kern = dict(LAUNCHES)
        t0 = time.perf_counter()
        if name == "A @ B":
            with spgemm.stage_timing() as ms:
                out["dist"][name] = fn()
                _sync(a.device)
            out["stages_ms"] = dict(ms)
        else:
            out["dist"][name] = fn()
            _sync(a.device)
        out["seconds"][name] = time.perf_counter() - t0
        out["collectives"][name] = {
            k: v - coll[k] for k, v in COLLECTIVE_STATS.items()
            if v != coll[k]}
        out["prologue"][name] = prologue_count() - pro
        out["strategy"][name] = [k for k in strategies
                                 if PLAN_STATS[f"dist_{k}"] > plan[k]]
        out["launches"][name] = {k: LAUNCHES[k] - v for k, v in kern.items()
                                 if LAUNCHES[k] != v}
    st = a._matmul_setup(b)
    plan = a._dist_plan(st)
    out["plan"] = {"strategy": plan.strategy, "expands": plan.expands,
                   "grid": plan.grid, "costs": plan.costs}
    out["selector"] = sel
    return out


# -- host checks ----------------------------------------------------------------

def _stats(x: Assoc) -> Tuple[int, float]:
    return x.nnz(), float(x.adj.sum())


def _tensor_stats(t: AssocTensor) -> Tuple[int, float]:
    n = int(t.nnz)
    return n, float(t.vals[:n].double().sum())


def _compare(name: str, got: AssocTensor, want: Assoc, full: bool):
    if full:
        g = got.to_assoc()
        return name, bool(g == want), f"nnz {g.nnz()} vs {want.nnz()}"
    g, w = _tensor_stats(got), _stats(want)
    return name, g == w, f"(nnz, sum) {g} vs {w}"


def _compare_vec(name: str, got: torch.Tensor, want: np.ndarray):
    g = got.double().cpu().numpy()
    ok = g.shape == want.shape and bool(np.array_equal(g, want))
    err = float(np.abs(g - want).max()) if g.shape == want.shape else None
    return name, ok, f"len {g.shape[0]} vs {want.shape[0]}, max |err| {err}"


def check_clustered(raw, results: dict, full: bool = False
                    ) -> List[Tuple[str, bool, str]]:
    """Hold the clustered results against host ``Assoc`` (values are 1.0,
    so every device sum is an exact integer and equality is exact)."""
    rows, cols, rows2, cols2 = raw
    ha = Assoc(rows, cols, 1.0)
    hb = Assoc(rows2, cols2, 1.0)
    sel = results["selector"]
    checks = [
        _compare("select", results["select"], ha[sel, :], full),
        _compare("add", results["add"], ha + hb, full),
        _compare("matmul", results["matmul"], ha @ hb, full),
    ]
    # sqout(reduce=1) = A·(Aᵀ·1): two sparse matvecs on scipy
    want = np.asarray(ha.adj @ (ha.adj.T @ np.ones(ha.adj.shape[0]))).ravel()
    checks.append(_compare_vec("sqout_reduce", results["sqout_reduce"], want))
    pipe = (ha.lazy()[sel, :] @ hb.lazy()).sum(axis=1).collect()
    checks.append(_compare_vec("pipeline", results["pipeline"],
                               np.asarray(pipe, np.float64)))
    return checks


def check_uniform(raw, results: dict, full: bool = True
                  ) -> List[Tuple[str, bool, str]]:
    """Hold the uniform results against host ``Assoc`` (integer values, so
    every fp32 sum here is exact and equality is exact)."""
    rows, cols, rows2, cols2, vals = raw
    ha = Assoc(rows, cols, vals)
    hb = Assoc(rows2, cols2, vals)
    sqout = np.asarray(ha.adj @ (ha.adj.T @ np.ones(ha.adj.shape[0]))).ravel()
    pipe = (ha.lazy()[results["selector"], :] @ hb.lazy()).sum(axis=1)
    return [
        _compare("uniform plus_times", results["plus_times"], ha @ hb, full),
        _compare("uniform min_plus", results["min_plus"],
                 ha.matmul(hb, MIN_PLUS), full),
        _compare_vec("uniform sqout_reduce", results["sqout_reduce"], sqout),
        _compare_vec("uniform matmul_reduce0", results["matmul_reduce0"],
                     np.asarray(ha.matmul_reduce(hb, axis=0), np.float64)),
        _compare_vec("uniform pipeline", results["pipeline"],
                     np.asarray(pipe.collect(), np.float64)),
    ]


def check_ingest(raw, results: dict) -> List[Tuple[str, bool, str]]:
    """Every snapshot against the one-shot host ``Assoc`` over the
    concatenated triples with the same aggregate, entry by entry; the
    selection against the oracle's; compaction's fold and version."""
    rows, cols, rows2, cols2, vals = raw
    size, batches = results["batch"], results["batches"]
    half = size * (batches // 2)

    def oracle(agg, n2, again=0):
        return Assoc(np.concatenate([rows, rows2[:n2], rows[:again]]),
                     np.concatenate([cols, cols2[:n2], cols[:again]]),
                     np.concatenate([vals, vals[:n2], vals[:again]]),
                     aggregate=agg)

    checks = []
    for agg, r in results["per_aggregate"].items():
        full_n = size * batches
        want_full = oracle(agg, full_n)
        checks += [
            _compare(f"ingest {agg} snapshot half", r["snap_half"],
                     oracle(agg, half), True),
            _compare(f"ingest {agg} snapshot full", r["snap_full"],
                     want_full, True),
            _compare(f"ingest {agg} select", r["select"],
                     want_full[r["selector"], :], True),
            _compare(f"ingest {agg} snapshot after compact", r["snap_after"],
                     oracle(agg, full_n, size), True),
        ]
        folded = r["compact"]["compacted"]
        checks.append((f"ingest {agg} compaction",
                       folded == full_n and r["version"] == 1,
                       f"folded {folded} of {full_n}, version {r['version']}"))
    return checks


def check_ingest_fallback(raw, results: dict) -> List[Tuple[str, bool, str]]:
    """Counts and checksum of the fallback snapshot against host
    ``Assoc`` (base with ``min`` as ``build_clustered`` builds it, then
    combined with the delta by ``sum``)."""
    rows, cols, rows2, cols2 = raw
    n = results["n_insert"]
    ha = Assoc(rows, cols, 1.0)
    delta = Assoc(rows2[:n], cols2[:n], 1.0, aggregate="sum")
    return [_compare("ingest fallback snapshot", results["snapshot"],
                     ha.combine(delta, "sum"), False)]


def _key_triples(x):
    """(row keys, col keys, values) of the stored entries of a host
    ``Assoc``, an ``AssocTensor`` or a ``DistAssoc`` (gathered: one
    collective), in (row, col) key order."""
    if isinstance(x, Assoc):
        coo = x.adj.tocoo()
        order = np.lexsort((coo.col, coo.row))
        return (x.row[coo.row[order]], x.col[coo.col[order]],
                coo.data[order].astype(np.float64))
    if isinstance(x, DistAssoc):
        x = x.gather_replicated()
    n = int(x.nnz)
    return (x.row_space.keys[x.rows[:n].cpu().numpy()],
            x.col_space.keys[x.cols[:n].cpu().numpy()],
            x.vals[:n].double().cpu().numpy())


def _same_triples(name: str, g, w):
    """Compare two :func:`_key_triples` results."""
    ok = len(g[0]) == len(w[0]) and all(np.array_equal(p, q)
                                       for p, q in zip(g, w))
    return name, ok, f"nnz {len(g[0])} vs {len(w[0])}"


def _vec_on(keys, vec_keys, vec, zero) -> np.ndarray:
    """``vec`` over ``vec_keys`` spread onto the (sorted) ``keys``, with
    ``zero`` at keys it does not hold."""
    out = np.full(len(keys), zero, np.float64)
    out[np.searchsorted(keys, vec_keys)] = np.asarray(vec, np.float64)
    return out


def check_dist(raw, drv: dict) -> List[Tuple[str, bool, str]]:
    """Every dist result of :func:`drive_dist` against the host ``Assoc``
    and against the device result beside it, exactly (the values are 1.0
    and 2.0, so every sum is an exact integer), and each dist operation's
    collectives against :data:`DIST_COLLECTIVES`."""
    rows, cols, rows2, cols2 = raw
    ha = Assoc(rows, cols, 1.0)
    hb = Assoc(rows2, cols2, 1.0)
    sel = drv["selector"]
    hsel = ha[sel, :]
    r, c, v = ha.triples()
    want_set = Assoc(r, c, np.where(np.isin(r, hsel.row), 2.0, v))
    arrays = {"select": hsel, "add": ha + hb, "mul": ha.mul(hb),
              "setitem": want_set,
              "lazy_select_add": hsel + hb[sel, :],
              "gather_replicated": ha}
    dist, dev = drv["dist"], drv["device"]
    checks = []
    for name, want in arrays.items():
        g = _key_triples(dist[name])
        checks.append(_same_triples(f"dist {name} vs host", g,
                                    _key_triples(want)))
        checks.append(_same_triples(f"dist {name} vs device", g,
                                    _key_triples(dev[name])))
    checks.append(("dist to_assoc vs host", bool(dist["to_assoc"] == ha),
                   f"nnz {dist['to_assoc'].nnz()} vs {ha.nnz()}"))
    # each vector: its semiring, the host's (keys, vector) and the keys of
    # the device vector; every dist vector lies on the union keyspaces
    loc, ta = dist["select"].local, dev["select"]
    col, row = (ha.col, ta.col_space.keys), (ha.row, ta.row_space.keys)
    hab = arrays["add"]
    vectors = {f"col_reduce {sr.name}": (sr, host_axis_reduce(ha, 0, sr), col)
               for sr in (PLUS_TIMES, MAX_PLUS)}
    vectors.update({f"row_reduce {sr.name}":
                    (sr, host_axis_reduce(ha, 1, sr), row)
                    for sr in (PLUS_TIMES, MAX_PLUS)})
    vectors["col_degree"] = (PLUS_TIMES, np.diff(ha.adj.tocsc().indptr), col)
    vectors["matmul_dense_vec"] = (
        PLUS_TIMES, np.asarray(ha.adj @ np.ones(len(ha.col))).ravel(), row)
    vectors["lazy_add_sum"] = (PLUS_TIMES,
                               host_axis_reduce(hab, 1, PLUS_TIMES),
                               (hab.row, loc.row_space.keys))
    for name, (sr, want, (host_keys, dev_keys)) in vectors.items():
        keys = (loc.col_space.keys if name.startswith("col")
                else loc.row_space.keys)
        w = _vec_on(keys, host_keys, want, sr.zero)
        g = dist[name].double().cpu().numpy()
        d = _vec_on(keys, dev_keys, dev[name].double().cpu().numpy(),
                    sr.zero)
        checks.append((f"dist {name} vs host", bool(np.array_equal(g, w)),
                       f"len {len(g)} vs {len(w)}"))
        checks.append((f"dist {name} vs device", bool(np.array_equal(g, d)),
                       f"len {len(g)} vs {len(d)}"))
    for name, want in DIST_COLLECTIVES.items():
        got = drv["collectives"][name]
        checks.append((f"dist {name} collectives", got == want,
                       f"{got} vs {want}"))
    return checks


def check_dist_ingest(dist_res: dict, dev_res: dict
                      ) -> List[Tuple[str, bool, str]]:
    """Each snapshot and selection of the ingest workload over a
    ``DistAssoc`` base against the same over an ``AssocTensor`` base,
    entry by entry (both are held against the host by
    :func:`check_ingest`)."""
    checks = []
    for agg, r in dist_res["per_aggregate"].items():
        d = dev_res["per_aggregate"][agg]
        for key in ("snap_half", "snap_full", "select", "snap_after"):
            checks.append(_same_triples(f"dist ingest {agg} {key} vs device",
                                        _key_triples(r[key]),
                                        _key_triples(d[key])))
    return checks


def _dist_stats(x) -> Tuple[int, float]:
    """(nnz, sum) of a ``DistAssoc`` (gathered) or an ``AssocTensor``."""
    if isinstance(x, DistAssoc):
        x = x.gather_replicated()
    return _tensor_stats(x)


def _vec_check(name, got, keys, host_keys, want, zero=0.0):
    """A dist vector over ``keys`` against a host vector over
    ``host_keys`` spread onto them."""
    w = _vec_on(keys, host_keys, want, zero)
    g = got.double().cpu().numpy()
    ok = g.shape == w.shape and bool(np.array_equal(g, w))
    return name, ok, f"len {len(g)} vs {len(w)}"


def check_dist_product(raw_c, raw_u, drv: dict, res: dict, res_u: dict,
                       dev_rows: np.ndarray, full: bool = False
                       ) -> List[Tuple[str, bool, str]]:
    """Every result of :func:`drive_dist_product` against the host
    ``Assoc`` (numpy/scipy) and against the main path's device result of
    the same operation where it has one (``res``: :func:`drive_clustered`
    over device arrays whose row keys are ``dev_rows``, ``res_u``:
    :func:`drive_uniform`), exactly (integer values: every fp32
    sum is exact in any order); clustered results by (nnz, sum), or entry
    by entry with ``full``; uniform results entry by entry.  Then the
    collectives of each operation against
    :data:`DIST_PRODUCT_COLLECTIVES` (and no prologue collective at one
    rank), and every strategy having run."""
    rows, cols, rows2, cols2 = raw_c
    ha, hb = Assoc(rows, cols, 1.0), Assoc(rows2, cols2, 1.0)
    d = drv["dist"]
    loc = d["A @ B"].local
    rk, ck = loc.row_space.keys, loc.col_space.keys
    sel = drv["selector"]
    prod = ha @ hb
    checks = []

    def same(name, got, want):
        if full:
            checks.append(_same_triples(name, _key_triples(got),
                                        _key_triples(want)))
        else:
            g = _dist_stats(got)
            w = _stats(want) if isinstance(want, Assoc) else _dist_stats(want)
            checks.append((name, g == w, f"(nnz, sum) {g} vs {w}"))

    for name in ("A @ B", "coo", "all_to_all", "2d"):
        same(f"dist product {name} vs host", d[name], prod)
        same(f"dist product {name} vs device", d[name], res["matmul"])
    same("dist product lazy_select_matmul vs host",
         d["lazy_select_matmul"], ha[sel, :] @ hb)
    adj = ha.adj.tocsr()
    sq = np.asarray(adj @ (adj.T @ np.ones(adj.shape[0]))).ravel()
    checks.append(_vec_check("dist product sqout_reduce vs host",
                             d["sqout_reduce"], rk, ha.row, sq))
    checks.append(_vec_check("dist product sqout_reduce vs device",
                             d["sqout_reduce"], rk,
                             dev_rows,
                             res["sqout_reduce"].double().cpu().numpy()))
    pipe = (ha.lazy()[sel, :] @ hb.lazy()).sum(axis=1).collect()
    checks.append(_vec_check("dist product pipeline vs host",
                             d["pipeline"], rk, ha.row,
                             np.asarray(pipe, np.float64)))
    checks.append(_vec_check("dist product pipeline vs device",
                             d["pipeline"], rk, dev_rows,
                             res["pipeline"].double().cpu().numpy()))
    mr0 = np.asarray(ha.matmul_reduce(hb, axis=0), np.float64)
    for name in ("matmul_reduce0 replicate", "matmul_reduce0 all_to_all"):
        checks.append(_vec_check(f"dist product {name} vs host", d[name],
                                 ck, hb.col, mr0))
    # sqin on scipy: AᵀA by (nnz, sum), and Aᵀ(A·1)
    ata = (adj.T @ adj).tocsr()
    g = _dist_stats(d["sqin"])
    w = (ata.nnz, float(ata.sum()))
    checks.append(("dist product sqin vs host", g == w,
                   f"(nnz, sum) {g} vs {w}"))
    sqin_vec = np.asarray(adj.T @ (adj @ np.ones(adj.shape[1]))).ravel()
    checks.append(_vec_check("dist product sqin_reduce vs host",
                             d["sqin_reduce"], ck, ha.col, sqin_vec))

    urows, ucols, urows2, ucols2, uvals = raw_u
    ua, ub = Assoc(urows, ucols, uvals), Assoc(urows2, ucols2, uvals)
    for name, want, dev in (
            ("uniform plus_times", ua @ ub, res_u["plus_times"]),
            ("uniform min_plus", ua.matmul(ub, MIN_PLUS), res_u["min_plus"])):
        g = _key_triples(d[name])
        checks.append(_same_triples(f"dist product {name} vs host", g,
                                    _key_triples(want)))
        checks.append(_same_triples(f"dist product {name} vs device", g,
                                    _key_triples(dev)))
    checks.append(_same_triples("dist product uniform sqin vs host",
                                _key_triples(d["uniform sqin"]),
                                _key_triples(ua.sqin())))
    uloc = d["uniform plus_times"].local
    checks.append(_vec_check(
        "dist product uniform sqin_reduce vs host", d["uniform sqin_reduce"],
        uloc.col_space.keys, ua.col,
        np.asarray(ua.sqin(reduce=1), np.float64)))

    for name, want in DIST_PRODUCT_COLLECTIVES.items():
        got = drv["collectives"][name]
        checks.append((f"dist product {name} collectives",
                       got == want and drv["prologue"][name] == 0,
                       f"{got} vs {want}, prologue {drv['prologue'][name]}"))
    ran = {k for v in drv["strategy"].values() for k in v}
    checks.append(("dist product strategies",
                   ran == {"replicate", "all_to_all", "2d"},
                   f"ran {sorted(ran)}"))
    return checks


# -- the query server over the resident arrays -------------------------------

# requests per mix: closed-loop clients x requests each (hot after one
# warm-up request; ingest: batches, each then read once; dist: plus one
# /tables listing)
SERVE_COUNTS = {"hot": (4, 6), "cold": (4, 3), "product": (2, 1),
                "dense": (2, 2), "ingest": (1, INGEST_BATCHES),
                "dist": (2, 3)}
# the kernel launches (LAUNCHES keys) each mix must make on the card: the
# fused select's rank box through range_mask, the pair kernels (the hot
# pipeline's reduce on the TF32 route), the block-masked dense reduce on
# both routes and the ingest merge's rank_count
SERVE_MIX_KERNELS = {
    "hot": ("range_mask", "bsr_pairlist_reduce", "bsr_pairlist_reduce_tf32"),
    "cold": ("range_mask", "bsr_pairlist_reduce"),
    "product": ("range_mask", "bsr_pairlist"),
    "dense": ("bsr_spgemm_reduce", "bsr_spgemm_reduce_tf32"),
    "ingest": ("rank_count",),
    "dist": ("range_mask",),
}
_SERVE_WINDOW = 16   # row keys of a cold, product or ingest read selection


def build_serve(clus: dict, uni: dict, dist: dict, ingest_base,
                device):
    """A query-server registry over arrays already built, so no
    ``from_triples`` runs again: the clustered ``edges``/``feat``
    (:func:`build_clustered`), the uniform ``U``/``V``
    (:func:`build_uniform`), the dist ``dA``/``dB`` (:func:`build_dist`)
    and a fresh ``aggregate="sum"`` :class:`IngestTable` ``ingest`` over
    ``ingest_base`` (a ``sum`` base of :func:`build_ingest`)."""
    from .serve import TableRegistry
    reg = TableRegistry(device)
    for name, arr in (("edges", clus["A"]), ("feat", clus["B"]),
                      ("U", uni["A"]), ("V", uni["B"]),
                      ("dA", dist["A"]), ("dB", dist["B"])):
        reg.register(name, arr)
    reg.register("ingest", IngestTable(ingest_base, aggregate="sum"))
    return reg


def _serve_windows(a, b, count: int) -> list:
    """``count`` distinct windows of 16 consecutive row keys of ``a`` (a
    rank range: a selection's box), each starting at a row that has an
    entry whose column is a row key of ``b`` (so its product is not
    empty), spread over the middle half of those rows."""
    n = int(a.nnz)
    rows = a.rows[:n].cpu().numpy()
    cols = a.cols[:n].cpu().numpy()
    good = np.unique(rows[np.isin(a.col_space.keys[cols],
                                  b.row_space.keys)])
    good = good[good + _SERVE_WINDOW <= len(a.row_space)]
    starts = good[np.linspace(len(good) // 4, 3 * len(good) // 4,
                              count).astype(np.int64)]
    if len(np.unique(starts)) < count:
        raise ValueError(f"{len(good)} rows with a product give no "
                         f"{count} distinct windows")
    keys = a.row_space.keys
    return [keys[s:s + _SERVE_WINDOW] for s in starts]


def _body_arrays(body: dict) -> dict:
    """A result body with its lists as numpy arrays (compact to keep)."""
    out = dict(body)
    for f in ("rows", "cols"):
        if f in out:
            out[f] = np.asarray(out[f])
    if "vals" in out:
        out["vals"] = np.asarray(out["vals"], np.float64)
    return out


def _same_body(a: dict, b: dict) -> bool:
    """Two result bodies equal: kind, counts and every list, exactly."""
    if a.keys() != b.keys():
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, np.ndarray):
            if v.shape != w.shape or not np.array_equal(
                    v, w, equal_nan=v.dtype.kind == "f"):
                return False
        elif v != w and not (isinstance(v, float) and np.isnan(v)
                             and np.isnan(w)):
            return False
    return True


def _percentiles(xs) -> dict:
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99))} if len(xs) else {})


def drive_serve(reg, sel, ingest_raw, *, workers: int = 4) -> dict:
    """Serve ``reg`` (:func:`build_serve`) on 127.0.0.1 and drive the mixes
    of :data:`SERVE_COUNTS` through :class:`~repro_torch.serve.D4MClient`
    threads, one mix after the other:

    * ``hot`` — ``(edges[sel, :] @ feat).sum(axis=1)``, one warm-up
      request, then every client repeats it;
    * ``cold`` — the same with a fresh ``Keys`` window of 16 row keys in
      every request;
    * ``product`` — ``edges[Keys(16 rows), :] @ feat`` (triples);
    * ``dense`` — ``(U @ V).sum(axis=1)`` under ``plus_times`` and
      ``min_plus``;
    * ``ingest`` — ``ingest_raw``'s second triples (:func:`build_ingest`)
      in :data:`INGEST_BATCHES` ``POST /ingest`` batches, each followed
      by a read of 16 of its row keys;
    * ``dist`` — ``(dA[sel, :] @ dB).sum(axis=1)`` and one ``/tables``.

    Per mix: client latencies, each request's server timing, the change
    of ``/stats`` (requests, batches, plan hits and misses), of the kernel
    launches and of the collectives, and wall seconds; over the phase,
    the control broadcasts.  After each mix (each ingest read: right
    after it) every distinct query is collected in process on the same
    resident arrays, timed, and its formatted result kept beside the
    served ones.  The server is closed before returning; then the ingest
    table's final snapshot is kept."""
    from concurrent.futures import ThreadPoolExecutor

    from .serve import D4MClient, TableRef, start_server, to_wire
    from .serve.engine import format_result

    n_cold = SERVE_COUNTS["cold"][0] * SERVE_COUNTS["cold"][1]
    windows = _serve_windows(reg.get("edges"), reg.get("feat"),
                             n_cold + SERVE_COUNTS["product"][0])
    E, F = TableRef("edges"), TableRef("feat")
    hot = to_wire((E[sel, :] @ F).sum(axis=1))
    cold = [to_wire((E[Keys(list(w)), :] @ F).sum(axis=1))
            for w in windows[:n_cold]]
    product = [to_wire(E[Keys(list(w)), :] @ F) for w in windows[n_cold:]]
    dense = [to_wire(TableRef("U").matmul(TableRef("V"), semiring=sr)
                     .sum(axis=1, semiring=sr))
             for sr in ("plus_times", "min_plus")]
    dist_q = to_wire((TableRef("dA")[sel, :] @ TableRef("dB")).sum(axis=1))
    device = reg.device

    def in_process(payload):
        from .serve import from_wire
        t0 = time.perf_counter()
        res = from_wire(payload, resolve=reg.resolve).collect()
        _sync(device)
        t1 = time.perf_counter()
        body = format_result(res)
        return _body_arrays(body), t1 - t0, time.perf_counter() - t1

    bcast0 = BROADCAST_STATS["broadcast"]
    srv = start_server(reg, workers=workers)
    client = D4MClient(srv.url, timeout=600)
    out = {"workers": srv.engine.workers, "mixes": {}, "in_process": {}}

    def request(c, kind, payload):
        t0 = time.perf_counter()
        resp = (c.query(payload) if kind == "query"
                else c.ingest(*payload))
        lat = time.perf_counter() - t0
        return {"latency_s": lat, "exec_s": resp["timing"]["exec_s"],
                "payload": payload, "body": _body_arrays(resp["result"])}

    def run_mix(name, per_client, after=None):
        """Each client thread runs its list of (kind, payload) in turn;
        ``after(record)`` runs after each request of its thread."""
        st0 = client.stats()
        launches = dict(LAUNCHES)
        coll = dict(COLLECTIVE_STATS)
        pro = prologue_count()
        t0 = time.perf_counter()

        def one(reqs):
            c = D4MClient(srv.url, timeout=600)
            recs = []
            for kind, payload in reqs:
                recs.append(request(c, kind, payload))
                if after is not None:
                    after(recs[-1])
            return recs
        with ThreadPoolExecutor(len(per_client)) as pool:
            futs = [pool.submit(one, reqs) for reqs in per_client]
            recs = [r for f in futs for r in f.result()]
        wall = time.perf_counter() - t0
        st1 = client.stats()
        s0, s1 = st0["server"], st1["server"]

        def delta(d1, d0, k):
            return d1.get(k, 0.0) - d0.get(k, 0.0)
        hits = delta(st1["plan"], st0["plan"], "plan_hits")
        misses = delta(st1["plan"], st0["plan"], "plan_misses")
        batches = delta(s1, s0, "batches")
        lat = [r["latency_s"] for r in recs]
        mix = {"requests": len(recs), "wall_s": wall,
               "throughput_rps": len(recs) / wall if wall else None,
               "latency_s": _percentiles(lat),
               "exec_s": _percentiles([r["exec_s"] for r in recs]),
               "plan_hits": hits, "plan_misses": misses,
               "plan_hit_rate": hits / (hits + misses) if hits + misses
               else None,
               "server_requests": delta(s1, s0, "requests"),
               "server_errors": delta(s1, s0, "errors"),
               "batch_mean": (delta(s1, s0, "batch_n") / batches
                              if batches else None),
               "launches": {k: LAUNCHES[k] - v for k, v in launches.items()
                            if LAUNCHES[k] != v},
               "collectives": {k: v - coll[k] for k, v in
                               COLLECTIVE_STATS.items() if v != coll[k]},
               "prologue": prologue_count() - pro, "records": recs}
        out["mixes"][name] = mix

    def collect_all(name, payloads):
        res = out["in_process"].setdefault(name, [])
        for p in payloads:
            body, t_collect, t_format = in_process(p)
            res.append({"payload": p, "body": body,
                        "collect_s": t_collect, "format_s": t_format})

    try:
        n_c, per = SERVE_COUNTS["hot"]
        out["hot_warmup"] = request(client, "query", hot)
        run_mix("hot", [[("query", hot)] * per for _ in range(n_c)])
        collect_all("hot", [hot])
        n_c, per = SERVE_COUNTS["cold"]
        run_mix("cold", [[("query", cold[i * per + j]) for j in range(per)]
                         for i in range(n_c)])
        collect_all("cold", cold)
        run_mix("product", [[("query", p)] for p in product])
        collect_all("product", product)
        n_c, per = SERVE_COUNTS["dense"]
        run_mix("dense", [[("query", dense[i])] * per for i in range(n_c)])
        collect_all("dense", dense)

        # ingest: each batch, then a read of 16 of its row keys (read your
        # writes), collected in process right after it
        _, _, rows2, cols2, vals = ingest_raw
        size = len(rows2) // INGEST_BATCHES
        reads = []
        seq = []
        for k in range(INGEST_BATCHES):
            part = slice(k * size, (k + 1) * size)
            w = np.unique(rows2[part])[:_SERVE_WINDOW]
            read = to_wire(TableRef("ingest")[Keys(list(w)), :])
            reads.append({"n": (k + 1) * size, "keys": w, "payload": read})
            seq += [("ingest", ("ingest", rows2[part], cols2[part],
                                vals[part])), ("query", read)]

        def after_ingest(rec):
            if rec["body"].get("kind") != "ingest":
                collect_all("ingest", [rec["payload"]])
        run_mix("ingest", [seq], after=after_ingest)
        out["ingest_reads"] = reads

        n_c, per = SERVE_COUNTS["dist"]
        run_mix("dist", [[("query", dist_q)] * per for _ in range(n_c)])
        collect_all("dist", [dist_q])
        coll, pro = collective_count(), prologue_count()
        t0 = time.perf_counter()
        out["tables"] = client.tables()
        out["tables_s"] = time.perf_counter() - t0
        out["tables_collectives"] = (collective_count() - coll,
                                     prologue_count() - pro)
    finally:
        srv.close()
    out["broadcasts"] = BROADCAST_STATS["broadcast"] - bcast0
    out["U_rows"] = reg.get("U").row_space.keys
    out["dA_rows"] = reg.get("dA").local.row_space.keys
    table = reg.ingest_table("ingest")
    out["ingest_final"] = _key_triples(table.snapshot())
    out["ingest_version"] = table.version
    out["selector"] = sel
    return out


def _payload_key(payload) -> str:
    import json
    return json.dumps(payload, sort_keys=True)


def _body_triples(body: dict):
    """A triples body as (rows, cols, vals) arrays in (row, col) order."""
    order = np.lexsort((body["cols"], body["rows"]))
    return (body["rows"][order], body["cols"][order],
            body["vals"][order])


def check_serve(raw_c, raw_u, raw_i, drv: dict
                ) -> List[Tuple[str, bool, str]]:
    """The served results of :func:`drive_serve` against the in-process
    ``collect()`` of the same query on the same resident arrays (every
    request: identical triples and vectors), one result per mix against
    the host ``Assoc`` (numpy/scipy) on the raw triples (exact: integer
    values), every ingest read against the host over base and the batches
    so far, and the final ingest snapshot against the host over all of
    them; no request failed, no hot request after the warm-up missed the
    plan cache, and the dist mix made the program collectives of
    :data:`DIST_PRODUCT_COLLECTIVES` per request (and no prologue
    collective at one rank)."""
    checks = []
    mixes, inproc = drv["mixes"], drv["in_process"]

    # every served query against its in-process collect()
    for name, mix in mixes.items():
        served = [r for r in mix["records"] if r["body"]["kind"] != "ingest"]
        if name == "hot":
            served.append(drv["hot_warmup"])
        if name == "ingest":   # each read beside its own in-process collect
            pairs = list(zip(served, inproc[name]))
        else:
            want = {_payload_key(r["payload"]): r for r in inproc[name]}
            pairs = [(r, want.get(_payload_key(r["payload"])))
                     for r in served]
        n = len(served)
        same = sum(int(w is not None and _same_body(r["body"], w["body"]))
                   for r, w in pairs)
        checks.append((f"serve {name}: served equals in-process collect",
                       n > 0 and same == n, f"{same} of {n} identical"))
        checks.append((f"serve {name}: no request failed",
                       mix["server_errors"] == 0
                       and mix["server_requests"] == mix["requests"],
                       f"{mix['server_errors']} errors, "
                       f"{mix['server_requests']} of {mix['requests']}"))

    rows, cols, rows2, cols2 = raw_c
    ha, hb = Assoc(rows, cols, 1.0), Assoc(rows2, cols2, 1.0)

    def first(name):
        return next(r for r in mixes[name]["records"]
                    if r["body"]["kind"] != "ingest")

    sel = drv["selector"]
    pipe = np.asarray((ha.lazy()[sel, :] @ hb.lazy()).sum(axis=1).collect(),
                      np.float64)
    hot = first("hot")["body"]["vals"]
    checks.append(("serve hot vs host", bool(np.array_equal(hot, pipe)),
                   f"len {len(hot)} vs {len(pipe)}"))
    rec = first("cold")
    w = _payload_keys(rec["payload"])
    want = np.asarray((ha.lazy()[Keys(w), :] @ hb.lazy()).sum(axis=1)
                      .collect(), np.float64)
    checks.append(("serve cold vs host",
                   bool(np.array_equal(rec["body"]["vals"], want)),
                   f"len {len(rec['body']['vals'])} vs {len(want)}"))
    rec = first("product")
    w = _payload_keys(rec["payload"])
    checks.append(_same_triples("serve product vs host",
                                _body_triples(rec["body"]),
                                _key_triples(ha[Keys(w), :] @ hb)))
    urows, ucols, urows2, ucols2, uvals = raw_u
    ua, ub = Assoc(urows, ucols, uvals), Assoc(urows2, ucols2, uvals)
    for rec in mixes["dense"]["records"]:
        sr = MIN_PLUS if "min_plus" in _payload_key(rec["payload"]) \
            else PLUS_TIMES
        prod = ua.matmul(ub, sr)
        want = _vec_on(drv["U_rows"], prod.row,
                       host_axis_reduce(prod, 1, sr), sr.zero)
        checks.append((f"serve dense {sr.name} vs host",
                       bool(np.array_equal(rec["body"]["vals"], want)),
                       f"len {len(rec['body']['vals'])} vs {len(want)}"))
    dist = first("dist")["body"]["vals"]
    want = _vec_on(drv["dA_rows"], ha.row, pipe, 0.0)
    checks.append(("serve dist vs host", bool(np.array_equal(dist, want)),
                   f"len {len(dist)} vs {len(want)}"))

    # ingest: read your writes, then the final snapshot
    irows, icols, irows2, icols2, ivals = raw_i
    reads = [r for r in mixes["ingest"]["records"]
             if r["body"]["kind"] != "ingest"]
    ok = len(reads) == len(drv["ingest_reads"])
    for got, read in zip(reads, drv["ingest_reads"]):
        n, keys = read["n"], read["keys"]
        ma, mb = np.isin(irows, keys), np.isin(irows2[:n], keys)
        want = Assoc(np.concatenate([irows[ma], irows2[:n][mb]]),
                     np.concatenate([icols[ma], icols2[:n][mb]]),
                     np.concatenate([ivals[ma], ivals[:n][mb]]),
                     aggregate="sum")
        ok &= _same_triples("", _body_triples(got["body"]),
                            _key_triples(want))[1]
    checks.append(("serve ingest: every read sees its writes (vs host)",
                   bool(ok), f"{len(reads)} reads"))
    n = len(irows2)
    want = Assoc(np.concatenate([irows, irows2]),
                 np.concatenate([icols, icols2]),
                 np.concatenate([ivals, ivals[:n]]), aggregate="sum")
    checks.append(_same_triples("serve ingest final snapshot vs host",
                                drv["ingest_final"], _key_triples(want)))

    hot = mixes["hot"]
    checks.append(("serve hot: every request after the warm-up hit the "
                   "plan cache", hot["plan_misses"] == 0
                   and hot["plan_hits"] >= hot["requests"],
                   f"hits {hot['plan_hits']}, misses {hot['plan_misses']}"))
    d = mixes["dist"]
    want = {k: v * d["requests"]
            for k, v in DIST_PRODUCT_COLLECTIVES["pipeline"].items()}
    checks.append(("serve dist collectives",
                   d["collectives"] == want and d["prologue"] == 0
                   and drv["tables_collectives"] == (0, 0),
                   f"{d['collectives']} vs {want}, prologue "
                   f"{d['prologue']}, /tables "
                   f"{drv['tables_collectives']}"))
    return checks


def _payload_keys(payload) -> np.ndarray:
    """The row keys of the ``Keys`` selection of a cold or product
    query's wire payload."""
    for node in payload["nodes"]:
        if node["op"] == "select":
            return np.asarray(node["row"]["keys"])
    raise ValueError("no selection in the payload")
