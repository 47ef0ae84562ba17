"""The device layer's main path, driven end to end and checked on the host.

Two workloads (:mod:`repro_torch.configs.d4m_bench`):

* **clustered** (Graphulo-style communities, values 1.0) — build A and B
  with ``from_triples``, select a row ``Range``, ``A + B``, ``A @ B`` (the
  planner picks ``bsr`` at the paper's sizes), ``A.sqout(reduce=1)`` (the
  fused pair-list reduce) and the lazy pipeline
  ``(A.lazy()[sel, :] @ B.lazy()).sum(axis=1).collect()``;
* **uniform** (the paper's own workload, values 1..100) —
  ``A.matmul(B)`` under ``PLUS_TIMES`` and ``MIN_PLUS`` (the planner picks
  ``dense``).

:func:`check_clustered` / :func:`check_uniform` hold the results against
the host ``Assoc`` (numpy/scipy) built from the same raw triples — a check
that shares no code with the torch device path.  ``full=True`` compares
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

__all__ = ["build_clustered", "build_uniform", "drive_clustered",
           "drive_uniform", "check_clustered", "check_uniform",
           "row_range"]


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
    clock = _Clock(a.device)
    out = {name: clock(name, a.matmul, b, sr)
           for name, sr in (("plus_times", PLUS_TIMES),
                            ("min_plus", MIN_PLUS))}
    out["seconds"] = clock.seconds
    return out


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
    rows, cols, rows2, cols2, vals = raw
    ha = Assoc(rows, cols, vals)
    hb = Assoc(rows2, cols2, vals)
    return [
        _compare("uniform plus_times", results["plus_times"], ha @ hb, full),
        _compare("uniform min_plus", results["min_plus"],
                 ha.matmul(hb, MIN_PLUS), full),
    ]
