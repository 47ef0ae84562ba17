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
  the collectives, strategy and kernel launches of each.

:func:`check_clustered` / :func:`check_uniform` / :func:`check_ingest` /
:func:`check_dist` / :func:`check_dist_product` hold the results against the host ``Assoc``
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

from .configs.d4m_bench import make_clustered, make_dataset
from .core import (MAX_PLUS, MIN_PLUS, PLAN_STATS, PLUS_TIMES, Assoc,
                   AssocTensor, DistAssoc, KeySpace, Range, spgemm)
from .core.collectives import (COLLECTIVE_STATS, collective_count,
                               prologue_count)
from .core.plan import host_axis_reduce
from .ingest import IngestTable
from .kernels import LAUNCHES

__all__ = ["build_clustered", "build_uniform", "build_ingest", "build_dist",
           "drive_clustered", "drive_uniform", "drive_ingest", "drive_dist",
           "drive_ingest_fallback", "drive_dist_product", "check_clustered",
           "check_uniform", "check_ingest", "check_ingest_fallback",
           "check_dist", "check_dist_ingest", "check_dist_product",
           "row_range", "DIST_COLLECTIVES", "DIST_PRODUCT_COLLECTIVES"]

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


# the collectives each dist operation of drive_dist makes: the numbers the
# JAX package's @contract declarations give (gather_replicated and
# to_assoc: one all_gather)
DIST_COLLECTIVES = {
    "select": 0, "add": 0, "mul": 0, "setitem": 0, "lazy_select_add": 0,
    "col_reduce plus_times": 1, "col_reduce max_plus": 1,
    "row_reduce plus_times": 1, "row_reduce max_plus": 1,
    "col_degree": 1, "matmul_dense_vec": 1, "lazy_add_sum": 1,
    "gather_replicated": 1, "to_assoc": 1,
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
# rank, by collective (no prologue collective runs at one rank): the JAX
# @contract of each program, gather_replicated's all_gather where the
# operation gathers (sqout, sqin, and a resident B in the lazy product)
DIST_PRODUCT_COLLECTIVES = {
    "A @ B": {}, "coo": {}, "all_to_all": {"all_to_all": 1}, "2d": {},
    "matmul_reduce0 replicate": {"all_reduce": 1},
    "matmul_reduce0 all_to_all": {"all_reduce": 1},
    "sqout_reduce": {"all_reduce": 1, "all_gather": 1},
    "sqin": {"all_gather": 1}, "sqin_reduce": {"all_gather": 1},
    "lazy_select_matmul": {"all_gather": 1},
    "pipeline": {"all_reduce": 1, "all_gather": 1},
    "uniform plus_times": {}, "uniform min_plus": {},
    "uniform sqin": {"all_gather": 1},
    "uniform sqin_reduce": {"all_gather": 1},
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
