"""repro_torch.serve — D4M-as-a-service: the resident sharded query server
(the port of ``repro.serve``, with the same ``__all__``).

The D4M line's endgame was always a database engine serving queries over
resident associative arrays (D4M: Bringing Associative Arrays to Database
Engines, arXiv:1508.07371; D4M 3.0, arXiv:1702.03253).  This package is
that layer for the reproduction: a long-lived process holds named
``Assoc``/``AssocTensor``/``DistAssoc`` tables resident (device tables
stay on the card, dist tables sharded over the ranks of a mesh), clients
ship *expression graphs* — not data — over a JSON wire format, and the
server plans each graph through the port's ``plan.optimize()`` so
structurally repeated queries hit the cross-collect ``_PLAN_CACHE``
across requests and clients.

* :mod:`~repro_torch.serve.wire`     — LazyExpr/Selector ⇄ JSON wire
  format (``TableRef`` leaves name resident tables; semirings by registry
  name).
* :mod:`~repro_torch.serve.registry` — named resident tables, loaded once
  at startup from triples files or generator configs.
* :mod:`~repro_torch.serve.engine`   — worker pool + admission/batching
  queue: compatible queued queries (same table set / same layer) are
  admitted as a batch; per-request timing; per-worker ``MetricsStore``
  telemetry ⊕-merged at read time; with dist tables, one executor in
  admission order on every rank (SPMD, rank 0 admitting).
* :mod:`~repro_torch.serve.server`   — stdlib ``ThreadingHTTPServer`` JSON
  transport (``/query``, ``/ingest``, ``/tables``, ``/stats``,
  ``/health``) + CLI.
* :mod:`~repro_torch.serve.client`   — thin stdlib HTTP client.

Dynamic ingest (:mod:`repro_torch.ingest`) plugs in here: a table
registered as an :class:`~repro_torch.ingest.IngestTable` accepts
``POST /ingest`` triple batches, queries against it resolve to its
merge-on-read snapshot, and the engine runs a background compactor.
"""
from .wire import (TableRef, WireError, from_wire, to_wire, sel_from_wire,
                   sel_to_wire, register_predicate, ingest_from_wire,
                   ingest_to_wire)
from .registry import TableRegistry
from .engine import Engine, serve_execute
from .server import D4MServer, start_server
from .client import D4MClient, ServerError

__all__ = [
    "TableRef", "WireError", "from_wire", "to_wire", "sel_from_wire",
    "sel_to_wire", "register_predicate", "ingest_from_wire",
    "ingest_to_wire", "TableRegistry", "Engine", "serve_execute",
    "D4MServer", "start_server", "D4MClient", "ServerError",
]
