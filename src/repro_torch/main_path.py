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
  over an array whose keyspace is too large to linearize into int32.

:func:`check_clustered` / :func:`check_uniform` / :func:`check_ingest` hold
the results against the host ``Assoc`` (numpy/scipy) built from the same
raw triples — a check that shares no code with the torch device path.  ``full=True`` compares
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
from .core import MIN_PLUS, PLUS_TIMES, Assoc, AssocTensor, Range
from .ingest import IngestTable

__all__ = ["build_clustered", "build_uniform", "build_ingest",
           "drive_clustered", "drive_uniform", "drive_ingest",
           "drive_ingest_fallback", "check_clustered", "check_uniform",
           "check_ingest", "check_ingest_fallback", "row_range"]

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


def row_range(a: AssocTensor) -> Range:
    """The row selection of the main path: the second quarter of A's row
    keys (a contiguous rank box, so it runs the range kernel)."""
    keys = a.row_space.keys
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


def build_ingest(n: int, device) -> dict:
    """The uniform triples at size n (values 1..100) and one base array
    over A's triples per ingest aggregate (built with that aggregate, so
    base ⊕ delta equals a one-shot build over all triples)."""
    d = make_dataset(n)
    vals = d["num_vals"] + 1.0
    bases = {agg: AssocTensor.from_triples(d["rows"], d["cols"], vals,
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


# -- host checks ----------------------------------------------------------------

def _stats(x: Assoc) -> Tuple[int, float]:
    return x.nnz(), float(x.adj.sum())


def _tensor_stats(t: AssocTensor) -> Tuple[int, float]:
    n = int(t.nnz)
    return n, float(t.vals[:n].double().sum())


def _compare(name: str, got: AssocTensor, want: Assoc, full: bool):
    if full:
        ok = got.to_assoc() == want
        return name, bool(ok), f"nnz {int(got.nnz)} vs {want.nnz()}"
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
