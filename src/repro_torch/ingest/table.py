"""LSM-style mutable overlay over a resident associative array.

:class:`IngestTable` wraps a base array of the host (``Assoc``) or device
(``AssocTensor``) layer with the Accumulo tablet-server write path:

* ``insert(rows, cols, vals)`` appends a raw triple batch to a host-side
  **delta buffer** — list appends only, no canonicalization, no device
  work;
* ``snapshot()`` is the **merge-on-read** view: base ⊕ delta through the
  overlay merge (:mod:`repro_torch.ingest.merge`), memoized per
  (version, delta-depth) so repeated reads between mutations reuse one
  merge;
* ``compact()`` folds the delta into a new base, bumps the table
  ``version``, and invalidates the planner/compile cache entries keyed on
  the retired arrays (:func:`repro_torch.core.plan.invalidate_plan_for` /
  :func:`repro_torch.core.select.invalidate_compiled_for`);
  :class:`Compactor` runs this in the background on a depth threshold or
  an idle timeout.

Aggregation matches a one-shot constructor over the concatenated
triples: ⊕ collisions combine base-first (the host ``combine`` order);
the device layer restricts ⊕ to the commutative monoids
(``sum``/``min``/``max``), host tables accept any ``Assoc`` aggregator
(including order-sensitive ``"concat"``).  One difference comes from the
layers themselves: the host constructor drops explicit-zero *raw* values
before aggregation while the device constructor drops zero *results*
after it — ingest keeps each layer's own semantics.  The sharded layer
(``DistAssoc``) is not ported yet and is rejected.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["IngestTable", "Compactor"]


def _next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


class IngestTable:
    """Mutable LSM overlay (delta buffer + merge-on-read + compaction)."""

    def __init__(self, base, *, aggregate: str = "sum",
                 compact_threshold: int = 4096, name: str = ""):
        from repro_torch.core import Assoc, AssocTensor

        if isinstance(base, Assoc):
            self.layer = "host"
        elif isinstance(base, AssocTensor):
            self.layer = "device"
        elif type(base).__name__ == "DistAssoc":
            raise TypeError(
                "IngestTable over a sharded DistAssoc is not ported yet: it "
                "comes with the port's DistAssoc (ROADMAP module step 6)")
        else:
            raise TypeError(
                f"IngestTable base must be Assoc/AssocTensor, got "
                f"{type(base).__name__}")
        if self.layer == "device":
            if base.val_space is not None:
                raise TypeError("device ingest requires numeric values")
            from .merge import _agg_op
            _agg_op(aggregate)   # validate early, not at first read

        self.base = base
        self.aggregate = aggregate
        self.compact_threshold = int(compact_threshold)
        self.name = name
        self.version = 0

        self._lock = threading.RLock()
        self._batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._depth = 0
        self._last_insert_t = time.monotonic()
        self._snap: Optional[Tuple[int, int, Any]] = None  # (ver, depth, arr)
        self._retired: List[Any] = []   # superseded arrays, pending invalidation
        self.stats: Dict[str, int] = {
            "inserts": 0, "insert_triples": 0, "reads": 0, "merges": 0,
            "compactions": 0,
        }

    # -- write path ----------------------------------------------------------
    def insert(self, rows, cols, vals) -> Dict[str, int]:
        """Append one raw triple batch (host work only: validation and a
        list append)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if not (len(rows) == len(cols) == len(vals)):
            raise ValueError(
                f"batch arrays must have equal length, got "
                f"{len(rows)}/{len(cols)}/{len(vals)}")
        if len(rows) == 0:
            return {"accepted": 0, "delta_depth": self._depth}
        if self.layer == "device" and vals.dtype.kind not in "fiub":
            raise TypeError(
                f"device ingest requires numeric values, got dtype "
                f"{vals.dtype}")
        if vals.dtype.kind in "fiub":
            vals = vals.astype(np.float64)
        with self._lock:
            self._batches.append((rows, cols, vals))
            self._depth += len(rows)
            self._last_insert_t = time.monotonic()
            self.stats["inserts"] += 1
            self.stats["insert_triples"] += len(rows)
            return {"accepted": len(rows), "delta_depth": self._depth}

    @property
    def delta_depth(self) -> int:
        return self._depth

    # -- read path (merge-on-read) -------------------------------------------
    def snapshot(self):
        """The queryable view: base ⊕ buffered delta.

        Memoized per (version, delta-depth): repeated reads between
        mutations reuse one merged array — the merge-on-read *hit* the
        stats report.  With an empty delta the base itself is returned
        (no copy, stable ``id`` ⇒ stable plan-cache keys)."""
        with self._lock:
            self.stats["reads"] += 1
            if self._depth == 0:
                return self.base
            if self._snap is not None and \
                    self._snap[:2] == (self.version, self._depth):
                return self._snap[2]
            self.stats["merges"] += 1
            merged = getattr(self, f"_merge_{self.layer}")()
            if self._snap is not None:
                self._retired.append(self._snap[2])
            self._snap = (self.version, self._depth, merged)
            return merged

    def _delta_triples(self):
        rows = np.concatenate([b[0] for b in self._batches])
        cols = np.concatenate([b[1] for b in self._batches])
        vals = np.concatenate([b[2] for b in self._batches])
        return rows, cols, vals

    def _merge_host(self):
        from repro_torch.core import Assoc
        r, c, v = self._delta_triples()
        delta = Assoc(r, c, v, aggregate=self.aggregate)
        return self.base.combine(delta, self.aggregate)

    def _union_spaces(self, d_rows, d_cols):
        """Union keyspaces + base rank maps (memoized in the keyspace
        layer); keeps the base space OBJECT when content is unchanged so
        digests and compile-cache keys stay put."""
        from repro_torch.core import KeySpace
        base = self.base
        rs, rmap, _ = base.row_space.union(KeySpace(d_rows))
        cs, cmap, _ = base.col_space.union(KeySpace(d_cols))
        if rs == base.row_space:
            rs = base.row_space
        if cs == base.col_space:
            cs = base.col_space
        rerank = rs is not base.row_space or cs is not base.col_space
        return rs, cs, rmap, cmap, rerank

    @staticmethod
    def _pad_ranks(r, c, v, cap: int, device):
        """Sentinel-pad rank triples to ``cap`` and upload them to
        ``device`` (the base's)."""
        from repro_torch.core.sorted_ops import INT_SENTINEL
        pad = cap - len(r)
        sent = np.full(pad, INT_SENTINEL, np.int32)
        rt = np.concatenate([r.astype(np.int32), sent])
        ct = np.concatenate([c.astype(np.int32), sent])
        vt = np.concatenate([v.astype(np.float32), np.zeros(pad, np.float32)])
        return tuple(torch.from_numpy(x).to(device) for x in (rt, ct, vt))

    def _merge_device(self):
        """Host keyspace work, then the device merge; each step is a span
        of :func:`repro_torch.core.spgemm.stage_timing`."""
        from repro_torch.core import AssocTensor
        from repro_torch.core.spgemm import _stage
        from .merge import merge_read

        dev = self.base.device
        with _stage("delta_keys", dev):    # host: key unions and ranks
            d_rows, d_cols, d_vals = self._delta_triples()
            rs, cs, rmap, cmap, rerank = self._union_spaces(d_rows, d_cols)
            rr, _ = rs.rank(d_rows)
            cr, _ = cs.rank(d_cols)
        with _stage("upload", dev):
            base = self.base if not rerank else \
                self.base.reranked(rs, cs, rmap, cmap)
            dr, dc, dv = self._pad_ranks(rr, cr, d_vals, _next_pow2(len(rr)),
                                         dev)
        with _stage("merge", dev):
            r, c, v, nnz = merge_read(base, dr, dc, dv, self.aggregate,
                                      nrows=len(rs), ncols=len(cs))
        return AssocTensor(r, c, v, nnz, rs, cs, None)

    # -- compaction ----------------------------------------------------------
    def compact(self) -> Dict[str, int]:
        """Fold delta into a new base (reusing the cached merge when the
        delta is unchanged), bump ``version``, and drop planner/compile
        cache entries keyed on the retired arrays."""
        from repro_torch.core.plan import invalidate_plan_for
        from repro_torch.core.select import invalidate_compiled_for

        with self._lock:
            if self._depth == 0:
                return {"compacted": 0, "version": self.version}
            folded = self._depth
            new_base = self.snapshot()
            retired = self._retired + [self.base]
            self._retired = []
            self._snap = None
            self.base = new_base
            self._batches = []
            self._depth = 0
            self.version += 1
            self.stats["compactions"] += 1
        # invalidation outside the lock: pure cache maintenance.  Retired
        # object refs are held until here, so their ids cannot be reused
        # by unrelated arrays before the caches drop them.
        n_plans = invalidate_plan_for([id(a) for a in retired])
        invalidate_compiled_for(self._stale_digests(retired, new_base))
        return {"compacted": folded, "version": self.version,
                "plans_invalidated": n_plans}

    @staticmethod
    def _stale_digests(retired, new_base) -> set:
        def spaces(a):
            rs = getattr(a, "row_space", None)
            cs = getattr(a, "col_space", None)
            return [s for s in (rs, cs) if s is not None]

        live = {s.digest for s in spaces(new_base)}
        return {s.digest for a in retired for s in spaces(a)} - live

    def maybe_compact(self, idle_s: float = 0.25) -> bool:
        """Compact if the delta crossed the threshold or went idle."""
        with self._lock:
            depth = self._depth
            idle = time.monotonic() - self._last_insert_t
        if depth == 0:
            return False
        if depth >= self.compact_threshold or idle >= idle_s:
            self.compact()
            return True
        return False

    # -- telemetry -----------------------------------------------------------
    def info(self) -> Dict[str, Any]:
        with self._lock:
            reads = self.stats["reads"]
            merges = self.stats["merges"]
            return {
                "ingest": True, "layer": self.layer,
                "aggregate": self.aggregate, "version": self.version,
                "delta_depth": self._depth,
                "compact_threshold": self.compact_threshold,
                **self.stats,
                "merge_hit_rate": (
                    (reads - merges) / reads if reads else 0.0),
            }


class Compactor:
    """Background compaction: polls a registry's ingest tables and folds
    delta into base on a depth threshold (the table's own
    ``compact_threshold``) or an idle timeout.  The registry needs
    ``ingest_names()`` and ``ingest_table(name)``."""

    def __init__(self, registry, *, interval_s: float = 0.05,
                 idle_s: float = 0.25):
        self.registry = registry
        self.interval_s = float(interval_s)
        self.idle_s = float(idle_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Compactor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="d4m-ingest-compactor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            for name in self.registry.ingest_names():
                try:
                    self.registry.ingest_table(name).maybe_compact(
                        idle_s=self.idle_s)
                except Exception:      # table dropped mid-iteration etc.
                    continue
