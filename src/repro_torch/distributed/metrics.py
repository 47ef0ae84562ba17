"""Telemetry as D4M associative arrays (the port of
``repro.distributed.metrics``: the same ``MetricsStore`` over the port's
host ``Assoc``).

Metrics are triples ``(step, metric_name) → value`` — an associative array.
Merging across hosts, restarts or duplicated retries is the semiring ⊕:

* idempotent aggregators (``max``/``min``/``last``) make merges retry-safe —
  re-reporting the same step after a restart cannot corrupt history;
* cross-host reduction of counters uses ``sum``; gauges use ``max``.

That uniform merge semantics is what lets the fault-tolerance layer replay
work without bookkeeping — D4M's aggregation-on-collision doing systems
work.

``log()`` is **buffered**: updates append to a pending triple buffer and
are folded into the table in one batched ``Assoc`` construction + at most
one ``combine`` on the next read (``flush()``), so a serve worker that
logs on every request pays no table rebuild for it.  ``canonicalize_np``
merges duplicate (step, name) runs left-to-right in stable input order,
so order-sensitive aggregates (``last``) see updates in log order.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

from repro_torch.core import Assoc

_COMBINE = {"last": lambda a, b: b, "max": max, "min": min,
            "sum": lambda a, b: a + b}


class MetricsStore:
    def __init__(self, aggregate="last"):
        self._table = Assoc()
        self.aggregate = aggregate
        self._pending_steps: List[float] = []
        self._pending_names: List[str] = []
        self._pending_vals: List[float] = []
        self._lock = threading.RLock()
        # incremented once per Assoc.combine call — the regression tests
        # pin "one combine per flush, zero per log"
        self.combine_calls = 0

    # -- writes (cheap: append-only) ----------------------------------------
    def log(self, step: int, values: Dict[str, float]):
        with self._lock:
            for n in values:
                self._pending_steps.append(float(step))
                self._pending_names.append(n)
                self._pending_vals.append(float(values[n]))

    # -- the batched fold ---------------------------------------------------
    def flush(self) -> None:
        """Fold every pending update into the table: one batched Assoc
        construction (intra-batch collisions resolved by ⊕ in log order)
        plus at most one ``combine`` against the existing table."""
        with self._lock:
            if not self._pending_steps:
                return
            upd = Assoc(self._pending_steps, self._pending_names,
                        self._pending_vals, aggregate=self.aggregate)
            self._pending_steps = []
            self._pending_names = []
            self._pending_vals = []
            if self._table.nnz():
                self._table = self._table.combine(
                    upd, _COMBINE[self.aggregate])
                self.combine_calls += 1
            else:
                self._table = upd

    @property
    def table(self) -> Assoc:
        """The materialized metrics table (flushes pending updates)."""
        self.flush()
        return self._table

    @table.setter
    def table(self, value: Assoc) -> None:
        with self._lock:
            self._table = value
            self._pending_steps = []
            self._pending_names = []
            self._pending_vals = []

    # -- reads --------------------------------------------------------------
    def merge(self, other: "MetricsStore") -> "MetricsStore":
        """Cross-host / cross-restart merge — ⊕ on collisions."""
        out = MetricsStore(self.aggregate)
        mine, theirs = self.table, other.table
        if mine.nnz() and theirs.nnz():
            out.table = mine.combine(theirs, _COMBINE[self.aggregate])
        else:
            out.table = (mine if mine.nnz() else theirs).copy()
        return out

    def series(self, name: str):
        table = self.table
        if table.nnz() == 0:
            return np.zeros((0,)), np.zeros((0,))
        col = table[:, name]
        r, _, v = col.triples()
        order = np.argsort(r.astype(float))
        return r.astype(float)[order], v[order]

    def to_dict(self) -> Dict:
        r, c, v = self.table.triples()
        return {"rows": r.tolist(), "cols": c.tolist(), "vals": v.tolist(),
                "aggregate": self.aggregate}

    @staticmethod
    def from_dict(d: Dict) -> "MetricsStore":
        ms = MetricsStore(d.get("aggregate", "last"))
        if d["rows"]:
            ms.table = Assoc(d["rows"], d["cols"], d["vals"])
        return ms
