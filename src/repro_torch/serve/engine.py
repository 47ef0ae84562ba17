"""Query engine: worker pool, admission/batching queue, live metrics.

The port of ``repro.serve.engine``.  The execution model is the D4M 3.0
server loop grown onto the lazy planner:

* **admission batching** — queued queries are *compatible* when they
  touch the same table set on the same layer(s).  A worker admitting work
  takes the oldest request plus up to ``max_batch - 1`` compatible queued
  requests and executes them back-to-back, so a burst of same-shape
  traffic runs against a warm plan cache instead of interleaving with
  unrelated shapes.  Batch sizes are recorded — ``/stats`` exposes the
  distribution.
* **cross-request plan caching** — every query executes through
  ``LazyExpr.collect()``, i.e. ``plan.optimize()`` memoized by the
  graph's structural key in ``_PLAN_CACHE``.  Resident tables make the
  ``Source`` identity stable, and the wire format preserves selector
  structure, so two clients sending the same query — or one client
  repeating it — plan once (``PLAN_STATS['plan_hits']`` counts this).
* **⊕-merged telemetry** — each worker logs into its own
  :class:`~repro_torch.distributed.metrics.MetricsStore` (no cross-thread
  contention); a ``/stats`` read ⊕-merges the per-worker stores on
  demand.

Ingest batches (``POST /ingest``) flow through the same queue under
disjoint admission keys — ``("ingest", table)`` vs ``("query", ...)`` —
so a mutation never batches with reads on the table it mutates; queries
over ingest tables bind their merge-on-read snapshot at execution time.
When the registry holds ingest tables the engine also runs a background
:class:`~repro_torch.ingest.Compactor`.

**SPMD mode.**  The JAX engine is a single controller: one process drives
every shard.  Here each shard of a ``DistAssoc`` is a process (a rank),
and every rank must make the same collectives in the same order.  So an
engine over a registry that holds a dist table (decided when the engine
is made) runs every admitted request — query, ingest, the ``/tables``
listing and compaction — on ONE executor thread, in admission order:

* rank 0 serves HTTP and admits; wire, admission and unknown-table
  errors stay synchronous there and never enter the queue;
* just before it executes a request, rank 0 sends it to the other ranks
  as one control message
  (:func:`~repro_torch.core.collectives.broadcast_bytes`: an int64
  length, then the JSON bytes of the request's kind, options and
  wire payload — names, not table data — or the ingest batch): **one
  counted broadcast per request**, none at one rank;
* ranks > 0 run :meth:`Engine.follow`: each message is decoded and
  executed by the same code against the rank's own shards, so a dist
  result's ``to_assoc`` gather or a reduction's ``all_reduce`` runs on
  every rank, the followers discard the body, and a query that raises
  raises on every rank at the same point (the error is caught on every
  rank, so the ranks stay in step);
* the ``/tables`` listing of a dist table (its ``nnz`` is one
  collective) and every compaction (rank 0's compactor only decides)
  run as requests too, so every rank reports the same ``version``;
* on :meth:`stop` rank 0 sends a stop message and the followers return.

Host and device tables alone keep the worker pool.  Worker threads on one
card share the default stream; ``spgemm.stage_timing()`` (a process-wide
flag that synchronizes in every thread) is meant to be off while serving.

The execution entry point :func:`serve_execute` carries a ``@contract``,
recorded as in the JAX package (:mod:`repro_torch.analysis.contracts`).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.collectives import broadcast_bytes
from repro_torch.distributed.metrics import MetricsStore

from .registry import TableRegistry
from .wire import WireError, from_wire, ingest_from_wire, table_names

__all__ = ["Engine", "QueryError", "serve_execute", "format_result"]

# requests the engine makes itself (not counted in /stats as requests);
# a "stop" message ends Engine.follow
_CONTROL_KINDS = ("compact", "tables")
_STOP = json.dumps({"kind": "stop"}).encode()


class QueryError(Exception):
    """Execution-time failure of a structurally valid query (wraps the
    underlying exception with a structured code for the transport)."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)

    def to_dict(self) -> dict:
        return {"code": self.code, "message": str(self)}


@contract(collectives=0, densify=False, name="serve.execute",
          note="shard-local serve queries: zero collectives, no "
               "densification — budgets inherited from the dispatched ops")
def serve_execute(expr):
    """THE server execution entry point: optimize (plan-cached) +
    execute one decoded expression graph."""
    return expr.collect()


def format_result(res, limit: Optional[int] = None) -> Dict[str, Any]:
    """Layer-native result → JSON-safe payload.

    Arrays return COO triples (gathered to host — the result of a query
    is small by design; resident operands never move; a ``DistAssoc``
    result is gathered by one collective on every rank), reductions
    return dense vectors or scalars (torch tensors read back from their
    device).
    """
    from repro_torch.core import Assoc, AssocTensor, DistAssoc

    if isinstance(res, (AssocTensor, DistAssoc)):
        res = res.to_assoc()
    if isinstance(res, Assoc) or res is None:
        if res is None:
            res = Assoc()
        r, c, v = res.triples()
        n = len(r)
        truncated = limit is not None and n > limit
        if truncated:
            r, c, v = r[:limit], c[:limit], v[:limit]
        return {"kind": "triples", "nnz": n,
                "rows": [x.item() if hasattr(x, "item") else x
                         for x in r.tolist()],
                "cols": [x.item() if hasattr(x, "item") else x
                         for x in c.tolist()],
                "vals": v.tolist(), "truncated": truncated}
    if isinstance(res, torch.Tensor):
        res = res.detach().cpu().numpy()
    if isinstance(res, np.ndarray):
        arr = np.asarray(res, dtype=np.float64)
        if arr.ndim == 0:
            return {"kind": "scalar", "val": float(arr)}
        return {"kind": "vector", "n": int(arr.shape[0]),
                "vals": arr.tolist()}
    if isinstance(res, (float, int, np.floating, np.integer)):
        return {"kind": "scalar", "val": float(res)}
    raise QueryError("bad_result",
                     f"unformattable result type {type(res).__name__}")


class _Request:
    """One admitted request (query, ingest batch or control request) +
    its future-ish result.  ``expr`` is ``None`` for ingest and control
    requests, for queries over ingest tables (those bind at execution
    time so the merge-on-read snapshot reflects every mutation admitted
    ahead of them) and on a follower rank."""

    __slots__ = ("payload", "expr", "options", "batch_key", "t_enqueue",
                 "event", "result", "error", "timing", "batch_size",
                 "kind", "data")

    def __init__(self, payload, expr, options, batch_key, *,
                 kind: str = "query", data=None):
        self.payload = payload
        self.expr = expr
        self.options = options
        self.batch_key = batch_key
        self.kind = kind
        self.data = data
        self.t_enqueue = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[Exception] = None
        self.timing: Dict[str, float] = {}
        self.batch_size = 1

    def wait(self, timeout: Optional[float] = None) -> dict:
        if not self.event.wait(timeout):
            raise QueryError("timeout", "query did not complete in time")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result

    def message(self) -> bytes:
        """The control message a follower rank executes this from."""
        return json.dumps({"kind": self.kind, "payload": self.payload,
                           "options": self.options}).encode()

    @classmethod
    def from_message(cls, msg: dict) -> "_Request":
        kind, payload = msg["kind"], msg.get("payload")
        data = None
        if kind == "ingest":
            data = ingest_from_wire(payload)
        elif kind in _CONTROL_KINDS:
            data = payload
        return cls(payload, None, msg.get("options") or {}, (kind,),
                   kind=kind, data=data)


class Engine:
    """Worker pool + admission queue over a :class:`TableRegistry` (one
    executor thread in SPMD mode: see the module docstring)."""

    def __init__(self, registry: TableRegistry, *, workers: int = 4,
                 max_batch: int = 8, batch_window_s: float = 0.0,
                 default_limit: Optional[int] = 100_000,
                 compact_interval_s: float = 0.05,
                 compact_idle_s: float = 0.25):
        self.registry = registry
        # the dist tables' mesh: SPMD mode, one executor in admission order
        self.mesh = registry.dist_mesh()
        self.workers = 1 if self.mesh is not None else max(1, int(workers))
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = float(batch_window_s)
        self.default_limit = default_limit
        self.compact_interval_s = float(compact_interval_s)
        self.compact_idle_s = float(compact_idle_s)
        self._compactor = None
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._threads: List[threading.Thread] = []
        self._stop = False
        self._started = False
        # per-worker stores: single-writer each, ⊕-merged on /stats reads
        self._stores = [MetricsStore("sum") for _ in range(self.workers)]
        self._latencies: deque = deque(maxlen=2048)   # recent, for p50/p99
        self._lat_lock = threading.Lock()
        self.t_start = time.time()

    @property
    def device(self) -> torch.device:
        return self.registry.device if self.mesh is None else self.mesh.device

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Engine":
        if self._started:
            return self
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0: call "
                               f"follow(), not start()")
        self._started = True
        self._stop = False
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 name=f"d4m-serve-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        if self.registry.ingest_names() and self.compact_interval_s > 0:
            from repro_torch.ingest import Compactor
            submit = None if self.mesh is None else self._compact_request
            self._compactor = Compactor(
                self.registry, interval_s=self.compact_interval_s,
                idle_s=self.compact_idle_s, submit=submit).start()
        return self

    def stop(self) -> None:
        if self._compactor is not None:
            self._compactor.stop()
            self._compactor = None
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # in SPMD mode the executor finishes its request (every rank is in
        # it) and then sends the followers their stop message
        for t in self._threads:
            t.join(timeout=5.0 if self.mesh is None else 300.0)
        self._threads.clear()
        self._started = False

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission ----------------------------------------------------------
    def _admission_key(self, payload) -> tuple:
        """Compatibility key: ``("query", table names, their layers)``.
        Same key ⇒ same resident operands and same execution layer ⇒
        batchable.  The ``"query"`` tag keeps the key space disjoint from
        ingest admission keys (``("ingest", table)``), so a mutation never
        batches with reads on the table it mutates."""
        tables = table_names(payload)
        if not tables:
            raise WireError("bad_payload",
                            "query references no tables")
        layers = tuple(self.registry.layer_of(n) for n in tables)
        return ("query", tables, layers)

    def _enqueue(self, req: _Request) -> _Request:
        with self._cv:
            self._queue.append(req)
            self._cv.notify()
        return req

    def submit(self, payload, options: Optional[dict] = None) -> _Request:
        """Validate + enqueue one wire payload; returns the request handle
        (``.wait()`` for the result).  Malformed payloads raise
        :class:`WireError` synchronously — they never enter the queue.

        Queries over read-only tables bind their ``Source`` arrays here
        (plan-cache keys resolve once); queries touching an ingest table
        only *validate* here and bind at execution time, so the snapshot
        they read reflects mutations admitted ahead of them."""
        if not self._started:
            raise RuntimeError("engine not started")
        from_wire(payload, resolve=None)        # structural validation first
        key = self._admission_key(payload)      # then table-name checks
        tables = key[1]
        if any(self.registry.is_ingest(n) for n in tables):
            expr = None                         # bind at execution time
        else:
            expr = from_wire(payload, resolve=self.registry.resolve)
        return self._enqueue(_Request(payload, expr, dict(options or {}),
                                      key))

    def submit_ingest(self, payload,
                      options: Optional[dict] = None) -> _Request:
        """Validate + enqueue one ingest batch (the POST /ingest body).
        Decoding and table checks are synchronous — ``WireError`` codes
        ``bad_batch`` / ``not_ingestable`` / ``unknown_table`` never enter
        the queue.  The admission key is ``("ingest", table)``: disjoint
        from every query key, so a mutation batch is only ever admitted
        with other mutations of the same table (applied in queue order).

        Ordering: within one synchronous client connection ingest→query
        is read-your-writes (the client holds the ingest response before
        it sends the read).  Across connections the only guarantee is
        queue order of *admission*; concurrent workers may overlap an
        ingest with an independent query."""
        if not self._started:
            raise RuntimeError("engine not started")
        name, rows, cols, vals = ingest_from_wire(payload)
        self.registry.ingest_table(name)        # raises if not ingestable
        return self._enqueue(_Request(payload, None, dict(options or {}),
                                      ("ingest", name), kind="ingest",
                                      data=(name, rows, cols, vals)))

    def _submit_control(self, kind: str, data=None) -> _Request:
        if not self._started:
            raise RuntimeError("engine not started")
        return self._enqueue(_Request(data, None, {}, (kind, data),
                                      kind=kind, data=data))

    def _compact_request(self, name: str) -> dict:
        """The SPMD compactor's action: compact ``name`` on every rank."""
        return self._submit_control("compact", name).wait(300.0)

    def query(self, payload, options: Optional[dict] = None,
              timeout: Optional[float] = 120.0) -> dict:
        """Synchronous submit + wait (the in-process client path)."""
        return self.submit(payload, options).wait(timeout)

    def ingest(self, payload, options: Optional[dict] = None,
               timeout: Optional[float] = 120.0) -> dict:
        """Synchronous ingest submit + wait."""
        return self.submit_ingest(payload, options).wait(timeout)

    def tables(self, timeout: Optional[float] = 120.0) -> list:
        """The ``/tables`` listing: in SPMD mode a request that every rank
        runs (a dist table's ``nnz`` is one collective)."""
        if self.mesh is None:
            return self.registry.list_info()
        return self._submit_control("tables").wait(timeout)[
            "result"]["tables"]

    # -- the worker ---------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Admit the oldest request + up to ``max_batch - 1`` compatible
        queued requests (same admission key), preserving queue order for
        the rest."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
            head = self._queue.popleft()
            batch = [head]
            if self.max_batch > 1:
                keep = deque()
                while self._queue and len(batch) < self.max_batch:
                    r = self._queue.popleft()
                    if r.batch_key == head.batch_key:
                        batch.append(r)
                    else:
                        keep.append(r)
                self._queue.extendleft(reversed(keep))
        if (len(batch) < self.max_batch and self.batch_window_s > 0):
            # optional accumulation window: let same-shape stragglers join
            time.sleep(self.batch_window_s)
            with self._cv:
                keep = deque()
                while self._queue and len(batch) < self.max_batch:
                    r = self._queue.popleft()
                    if r.batch_key == head.batch_key:
                        batch.append(r)
                    else:
                        keep.append(r)
                self._queue.extendleft(reversed(keep))
        return batch

    def _set_device(self) -> None:
        # the current CUDA device is per thread: launch on the tables' card
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _worker_loop(self, idx: int) -> None:
        self._set_device()
        try:
            while True:
                batch = self._take_batch()
                if not batch:
                    if self._stop:
                        return
                    continue
                # re-read per iteration: reset_stats() swaps the store list
                store = self._stores[idx]
                if batch[0].kind not in _CONTROL_KINDS:
                    store.log(0, {"batches": 1.0,
                                  "batch_n": float(len(batch))})
                for req in batch:
                    req.batch_size = len(batch)
                    if self.mesh is not None:
                        broadcast_bytes(req.message(), self.mesh)
                    self._run(req, store)
        finally:
            if self.mesh is not None:
                broadcast_bytes(_STOP, self.mesh)

    def follow(self) -> int:
        """Ranks > 0 of SPMD mode: execute rank 0's requests, in its
        order, until it stops; returns the number of requests run."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on ranks > 0 of a registry "
                               "that holds dist tables")
        self._set_device()
        n = 0
        while True:
            msg = json.loads(broadcast_bytes(None, self.mesh))
            if msg["kind"] == "stop":
                return n
            self._run(_Request.from_message(msg), self._stores[0])
            n += 1

    def _execute(self, req: _Request) -> dict:
        """One request's result body (raises on failure)."""
        if req.kind == "ingest":
            name, rows, cols, vals = req.data
            table = self.registry.ingest_table(name)
            out = table.insert(rows, cols, vals)
            return {"kind": "ingest", "table": name,
                    "version": table.version, **out}
        if req.kind == "compact":
            out = self.registry.ingest_table(req.data).compact()
            return {"kind": "compact", "table": req.data, **out}
        if req.kind == "tables":
            return {"tables": self.registry.list_info()}
        if req.expr is None:    # ingest-table query or follower: bind now
            req.expr = from_wire(req.payload, resolve=self.registry.resolve)
        res = serve_execute(req.expr)
        return format_result(res, limit=req.options.get("limit",
                                                        self.default_limit))

    def _run(self, req: _Request, store: MetricsStore) -> None:
        """Execute ``req``, set its result or error, log it, wake it."""
        t0 = time.perf_counter()
        try:
            body = self._execute(req)
        except (WireError, QueryError) as exc:
            req.error = exc
        except Exception as exc:   # execution-time type errors etc.
            req.error = QueryError("execution_error",
                                   f"{type(exc).__name__}: {exc}")
        else:
            t1 = time.perf_counter()
            req.timing = {
                "queue_s": round(t0 - req.t_enqueue, 6),
                "exec_s": round(t1 - t0, 6),
                "total_s": round(t1 - req.t_enqueue, 6),
            }
            req.result = {"result": body, "timing": req.timing,
                          "batch": req.batch_size}
            if req.kind == "ingest":
                store.log(0, {"ingests": 1.0,
                              "ingest_triples": float(body["accepted"])})
        if req.kind not in _CONTROL_KINDS:
            t_total = time.perf_counter() - req.t_enqueue
            store.log(0, {"requests": 1.0,
                          "errors": 1.0 if req.error else 0.0,
                          "latency_s": t_total})
            with self._lat_lock:
                self._latencies.append(t_total)
        req.event.set()

    # -- telemetry ----------------------------------------------------------
    def metrics(self) -> MetricsStore:
        """⊕-merge of every worker's store (one ``combine`` per worker)."""
        merged = MetricsStore("sum")
        for s in self._stores:
            merged = merged.merge(s)
        return merged

    def stats(self) -> Dict[str, Any]:
        """The /stats body: server counters + core telemetry dicts."""
        from repro_torch.core import (CACHE_STATS, DISPATCH_STATS,
                                      PLAN_STATS, UNION_STATS)

        merged = self.metrics()
        server: Dict[str, float] = {}
        if merged.table.nnz():
            _, names, vals = merged.table.triples()
            for n, v in zip(names.tolist(), vals.tolist()):
                server[str(n)] = server.get(str(n), 0.0) + float(v)
        with self._lat_lock:
            lats = sorted(self._latencies)
        if lats:
            server["p50_s"] = float(np.percentile(lats, 50))
            server["p99_s"] = float(np.percentile(lats, 99))
        n_req = server.get("requests", 0.0)
        if server.get("batches"):
            server["batch_mean"] = server["batch_n"] / server["batches"]
        server["uptime_s"] = time.time() - self.t_start
        if n_req and server.get("latency_s") is not None:
            server["latency_mean_s"] = server["latency_s"] / n_req
        out = {
            "server": server,
            "plan": dict(PLAN_STATS),
            "cache": dict(CACHE_STATS),
            "union": dict(UNION_STATS),
            "dispatch": dict(DISPATCH_STATS),
            "queue_depth": len(self._queue),
            "workers": self.workers,
        }
        ingest_names = self.registry.ingest_names()
        if ingest_names:
            out["ingest"] = {n: self.registry.ingest_table(n).info()
                             for n in ingest_names}
        return out

    def reset_stats(self) -> None:
        """Zero core + server telemetry (a fresh measurement window —
        the bench harness calls this between hot/cold mixes)."""
        from repro_torch.core import reset_all_stats
        reset_all_stats()
        self._stores = [MetricsStore("sum") for _ in range(self.workers)]
        with self._lat_lock:
            self._latencies.clear()
