"""LSM-style mutable overlay over a resident associative array.

:class:`IngestTable` wraps a base array from any of the three layers
(host ``Assoc``, device ``AssocTensor``, sharded ``DistAssoc``) with the
Accumulo tablet-server write path:

* ``insert(rows, cols, vals)`` appends a raw triple batch to a host-side
  **delta buffer** — list appends only, no canonicalization, no device
  work; for the sharded layer the batch is routed by key interval to the
  owning row shard (zero collectives);
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
the device and dist layers restrict ⊕ to the commutative monoids
(``sum``/``min``/``max``), host tables accept any ``Assoc`` aggregator
(including order-sensitive ``"concat"``).  One difference comes from the
layers themselves: the host constructor drops explicit-zero *raw* values
before aggregation while the device constructor drops zero *results*
after it — ingest keeps each layer's own semantics.  A dist table is
driven SPMD, as its ``DistAssoc`` is: every rank inserts the same batches
and reads the same snapshots, and each merges only its own shard.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["IngestTable", "Compactor"]


def _next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _boundary_keys(space, bounds) -> np.ndarray:
    """First key of shards 1..S-1 — the key-interval routing table."""
    keys = space.keys
    if len(keys) == 0:
        return keys[:0]
    idx = np.minimum(np.asarray(bounds[1:-1], dtype=np.int64),
                     len(keys) - 1)
    return keys[idx]


class IngestTable:
    """Mutable LSM overlay (delta buffer + merge-on-read + compaction)."""

    def __init__(self, base, *, aggregate: str = "sum",
                 compact_threshold: int = 4096, name: str = ""):
        from repro_torch.core import Assoc, AssocTensor, DistAssoc

        if isinstance(base, Assoc):
            self.layer = "host"
        elif isinstance(base, AssocTensor):
            self.layer = "device"
        elif isinstance(base, DistAssoc):
            self.layer = "dist"
        else:
            raise TypeError(
                f"IngestTable base must be Assoc/AssocTensor/DistAssoc, got "
                f"{type(base).__name__}")
        if self.layer in ("device", "dist"):
            if getattr(base, "local", base).val_space is not None:
                raise TypeError(f"{self.layer} ingest requires numeric "
                                f"values")
            from .merge import _agg_op
            _agg_op(aggregate)   # validate early, not at first read

        self.base = base
        self.aggregate = aggregate
        self.compact_threshold = int(compact_threshold)
        self.name = name
        self.version = 0

        self._lock = threading.RLock()
        # host/device: one flat batch list; dist: one list per shard
        self._batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._shard_batches: List[List[Tuple]] = []
        self._depth = 0
        self._last_insert_t = time.monotonic()
        self._snap: Optional[Tuple[int, int, Any]] = None  # (ver, depth, arr)
        self._retired: List[Any] = []   # superseded arrays, pending invalidation
        self.stats: Dict[str, int] = {
            "inserts": 0, "insert_triples": 0, "reads": 0, "merges": 0,
            "compactions": 0,
        }
        if self.layer == "dist":
            self._nshards = base.mesh.shape["data"]
            self._shard_batches = [[] for _ in range(self._nshards)]
            self._bkeys = _boundary_keys(base.local.row_space,
                                         base.row_bounds)

    # -- write path ----------------------------------------------------------
    def insert(self, rows, cols, vals) -> Dict[str, int]:
        """Append one raw triple batch (host work only: validates, and for
        the dist layer routes each triple to its owning row shard by key
        interval — the zero-collective ingest path)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if not (len(rows) == len(cols) == len(vals)):
            raise ValueError(
                f"batch arrays must have equal length, got "
                f"{len(rows)}/{len(cols)}/{len(vals)}")
        if len(rows) == 0:
            return {"accepted": 0, "delta_depth": self._depth}
        if self.layer in ("device", "dist") and vals.dtype.kind not in "fiub":
            raise TypeError(
                f"{self.layer} ingest requires numeric values, got dtype "
                f"{vals.dtype}")
        if vals.dtype.kind in "fiub":
            vals = vals.astype(np.float64)
        with self._lock:
            if self.layer == "dist" and not len(self._bkeys):
                self._shard_batches[0].append((rows, cols, vals))  # 1 shard
            elif self.layer == "dist":
                shard = np.searchsorted(self._bkeys, rows, side="right")
                for s in range(self._nshards):
                    m = shard == s
                    if m.any():
                        self._shard_batches[s].append(
                            (rows[m], cols[m], vals[m]))
            else:
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
        base = self.base if self.layer == "device" else self.base.local
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

    def _merge_dist(self):
        """Every rank: the union keyspaces and new bounds over all shards'
        deltas (host); then its own shard's merge (no collective)."""
        from repro_torch.core import AssocTensor, DistAssoc
        from repro_torch.core.assoc_tensor import _upload_map
        from repro_torch.core.spgemm import _stage
        from .merge import dist_merge

        base = self.base
        dev = base.device
        with _stage("delta_keys", dev):    # host: key unions and ranks
            per_shard = [self._shard_triples(s) for s in range(self._nshards)]
            d_rows = np.concatenate([t[0] for t in per_shard])
            d_cols = np.concatenate([t[1] for t in per_shard])
            rs, cs, rmap, cmap, rerank = self._union_spaces(d_rows, d_cols)
            # new shard bounds: ranks of the old boundary KEYS in the union
            # space — key-interval ownership is the invariant, so the
            # insert routing and the rank partition stay consistent
            nb = np.empty(self._nshards + 1, dtype=np.int64)
            nb[0], nb[-1] = 0, len(rs)
            if len(self._bkeys):
                nb[1:-1] = np.searchsorted(rs.keys, self._bkeys, side="left")
            else:
                nb[1:-1] = len(rs)
            capd = _next_pow2(max((len(t[0]) for t in per_shard), default=8))
            r_k, c_k, v = per_shard[base.mesh.rank]
            rr, _ = rs.rank(r_k)
            cr, _ = cs.rank(c_k)
        with _stage("upload", dev):
            dr, dc, dv = self._pad_ranks(rr, cr, v, capd, dev)
            rm = _upload_map(rmap if rerank else [], dev)
            cm = _upload_map(cmap if rerank else [], dev)
        with _stage("merge", dev):
            r, c, vv, nnz = dist_merge(base.local, dr, dc, dv, rm, cm,
                                       self.aggregate, rerank)
        return DistAssoc(AssocTensor(r, c, vv, nnz, rs, cs, None), base.mesh,
                         row_bounds=nb)

    def _shard_triples(self, s: int):
        batches = self._shard_batches[s]
        if not batches:
            e = self.base.local.row_space.keys[:0]
            return e, e, np.empty(0, np.float64)
        return (np.concatenate([b[0] for b in batches]),
                np.concatenate([b[1] for b in batches]),
                np.concatenate([b[2] for b in batches]))

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
            if self.layer == "dist":
                self._shard_batches = [[] for _ in range(self._nshards)]
                self._bkeys = _boundary_keys(new_base.local.row_space,
                                             new_base.row_bounds)
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
            loc = getattr(a, "local", a)
            rs = getattr(loc, "row_space", None)
            cs = getattr(loc, "col_space", None)
            return [s for s in (rs, cs) if s is not None]

        live = {s.digest for s in spaces(new_base)}
        return {s.digest for a in retired for s in spaces(a)} - live

    def compaction_due(self, idle_s: float = 0.25) -> bool:
        """Whether the delta crossed the threshold or went idle."""
        with self._lock:
            depth = self._depth
            idle = time.monotonic() - self._last_insert_t
        return depth > 0 and (depth >= self.compact_threshold
                              or idle >= idle_s)

    def maybe_compact(self, idle_s: float = 0.25) -> bool:
        """Compact if the delta crossed the threshold or went idle."""
        if self.compaction_due(idle_s):
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
    ``ingest_names()`` and ``ingest_table(name)``.

    With ``submit``, the thread only decides: it calls ``submit(name)``
    for a table that is due, and ``submit`` compacts it (the query
    engine's SPMD mode sends the compaction to every rank as a request)."""

    def __init__(self, registry, *, interval_s: float = 0.05,
                 idle_s: float = 0.25,
                 submit: Optional[Callable[[str], Any]] = None):
        self.registry = registry
        self.interval_s = float(interval_s)
        self.idle_s = float(idle_s)
        self.submit = submit
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
                    table = self.registry.ingest_table(name)
                    if self.submit is None:
                        table.maybe_compact(idle_s=self.idle_s)
                    elif table.compaction_due(self.idle_s):
                        self.submit(name)
                except Exception:      # table dropped mid-iteration etc.
                    continue
