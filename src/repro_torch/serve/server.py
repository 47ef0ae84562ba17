"""HTTP transport for the query engine (stdlib ``ThreadingHTTPServer``).

The port of ``repro.serve.server``: the same endpoints, status codes and
error bodies.

Endpoints (all JSON):

* ``POST /query``  — body ``{"expr": <wire payload>, "options": {...}}``;
  200 → ``{"result": ..., "timing": {...}, "batch": k}``; malformed
  payloads → 400 with ``{"error": {"code", "message"}}`` (never a bare
  500 for wire errors).
* ``POST /ingest`` — body ``{"ingest": {"table", "rows", "cols",
  "vals"}}`` (see :func:`~repro_torch.serve.wire.ingest_to_wire`); 200 →
  ``{"result": {"kind": "ingest", "accepted", "delta_depth",
  "version"}}``; malformed batches → 400 ``bad_batch``, read-only
  tables → 400 ``not_ingestable``.
* ``GET /tables``  — registry listing (name/layer/shape/nnz per table;
  with a dist table a request that every rank runs).
* ``GET /stats``   — server request/latency/batch metrics ⊕-merged across
  workers + the core telemetry dicts (``plan``/``cache``/``union``/
  ``dispatch``) — ``plan.plan_hits`` is the cross-request plan-cache
  signal.
* ``POST /stats/reset`` — zero the measurement window (bench harness).
* ``GET /health``  — liveness + table count.

CLI::

    python -m repro_torch.serve.server --tables tables.json --port 8642 \
        --workers 4 --max-batch 8 [--device cpu]

where ``tables.json`` is a list of registry spec dicts (see
:mod:`~repro_torch.serve.registry`), or inline JSON starting with
``[``/``{``.  Tables live on ``--device`` (``cuda`` by default).  Dist
tables over several ranks run SPMD: start one process per rank with the
same specs and ``--rank r --world-size P --store-path <file every rank
opens>``; rank r runs on ``cuda:r``, rank 0 serves HTTP and the others
follow it (:meth:`~repro_torch.serve.engine.Engine.follow`).
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .engine import Engine, QueryError
from .registry import TableRegistry
from .wire import WireError

__all__ = ["D4MServer", "start_server", "main"]

_MAX_BODY = 64 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server_version = "d4m-serve/1"
    protocol_version = "HTTP/1.1"

    # silence per-request stderr logging (the server is long-lived)
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def engine(self) -> Engine:
        return self.server.engine          # type: ignore[attr-defined]

    def _send(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, code: str, message: str) -> None:
        self._send(status, {"error": {"code": code, "message": message}})

    def do_GET(self) -> None:  # noqa: N802
        try:
            if self.path == "/health":
                self._send(200, {"status": "ok",
                                 "tables": len(self.engine.registry)})
            elif self.path == "/tables":
                self._send(200, {"tables": self.engine.tables()})
            elif self.path == "/stats":
                self._send(200, self.engine.stats())
            else:
                self._error(404, "not_found", f"no endpoint {self.path!r}")
        except Exception as exc:   # pragma: no cover - defensive
            self._error(500, "internal", f"{type(exc).__name__}: {exc}")

    def do_POST(self) -> None:  # noqa: N802
        try:
            if self.path == "/stats/reset":
                self.engine.reset_stats()
                self._send(200, {"status": "reset"})
                return
            if self.path not in ("/query", "/ingest"):
                self._error(404, "not_found", f"no endpoint {self.path!r}")
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                self._error(400, "bad_payload",
                            f"Content-Length {length} out of range")
                return
            try:
                body = json.loads(self.rfile.read(length))
            except (ValueError, UnicodeDecodeError) as exc:
                self._error(400, "bad_payload", f"invalid JSON: {exc}")
                return
            if not isinstance(body, dict):
                self._error(400, "bad_payload", "body must be a JSON dict")
                return
            options = body.get("options") or {}
            if not isinstance(options, dict):
                self._error(400, "bad_payload", "'options' must be a dict")
                return
            try:
                if self.path == "/ingest":
                    # accept either a bare wire payload or {"ingest": ...}
                    # nested like /query's {"expr": ...}
                    payload = body if "ingest" in body else body.get("expr")
                    req = self.engine.submit_ingest(payload, options)
                else:
                    if "expr" not in body:
                        self._error(400, "bad_payload",
                                    "body must be {'expr': <wire payload>, "
                                    "'options': {...}?}")
                        return
                    req = self.engine.submit(body["expr"], options)
                out = req.wait(timeout=float(options.get("timeout_s", 120)))
            except WireError as exc:
                self._error(400, exc.code, str(exc))
                return
            except QueryError as exc:
                status = 504 if exc.code == "timeout" else 422
                self._error(status, exc.code, str(exc))
                return
            self._send(200, out)
        except Exception as exc:   # pragma: no cover - defensive
            self._error(500, "internal", f"{type(exc).__name__}: {exc}")


class D4MServer(ThreadingHTTPServer):
    """HTTP server owning an :class:`Engine` (and through it the resident
    table registry)."""

    daemon_threads = True

    def __init__(self, registry: TableRegistry, host: str = "127.0.0.1",
                 port: int = 0, *, workers: int = 4, max_batch: int = 8,
                 batch_window_s: float = 0.0):
        self.engine = Engine(registry, workers=workers, max_batch=max_batch,
                             batch_window_s=batch_window_s)
        super().__init__((host, port), _Handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def start_background(self) -> "D4MServer":
        self.engine.start()
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="d4m-serve-http", daemon=True)
        self._serve_thread.start()
        return self

    def close(self) -> None:
        self.shutdown()
        self.engine.stop()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
            self._serve_thread = None


def start_server(registry: TableRegistry, *, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 4, max_batch: int = 8,
                 batch_window_s: float = 0.0) -> D4MServer:
    """Boot a server on a background thread; ``port=0`` picks a free
    port.  Caller owns ``server.close()``."""
    return D4MServer(registry, host, port, workers=workers,
                     max_batch=max_batch,
                     batch_window_s=batch_window_s).start_background()


def _load_specs(arg: str):
    if arg.lstrip().startswith(("[", "{")):
        specs = json.loads(arg)
    else:
        with open(arg) as f:
            specs = json.load(f)
    if isinstance(specs, dict):
        specs = [specs]
    return specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="D4M query server over resident associative arrays")
    ap.add_argument("--tables", required=True,
                    help="path to a JSON list of table specs, or inline "
                         "JSON ('[{\"name\": ...}]')")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where device and dist tables live (cuda or cpu)")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank of a dist registry")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--store-path", default=None,
                    help="the FileStore file every rank opens (needed "
                         "with --world-size > 1)")
    args = ap.parse_args(argv)

    mesh = None
    if args.world_size > 1:
        from repro_torch.core import make_mesh
        mesh = make_mesh(args.device, rank=args.rank,
                         world_size=args.world_size,
                         store_path=args.store_path)
    registry = TableRegistry.from_specs(_load_specs(args.tables), mesh=mesh,
                                        device=args.device)
    if args.rank > 0:
        n = Engine(registry).follow()
        print(f"[d4m-serve] rank {args.rank}: followed rank 0 through {n} "
              f"request(s)")
        return 0
    server = D4MServer(registry, args.host, args.port,
                       workers=args.workers, max_batch=args.max_batch,
                       batch_window_s=args.batch_window_ms / 1e3)
    server.engine.start()
    print(f"[d4m-serve] {len(registry)} table(s) resident "
          f"({', '.join(registry.names())}); serving on {server.url} "
          f"with {args.workers} worker(s), max_batch={args.max_batch}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
