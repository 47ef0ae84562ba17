"""Thin stdlib HTTP client for the D4M query server (the port of
``repro.serve.client``; it talks to a server of either package).

Build queries over :class:`~repro_torch.serve.wire.TableRef` leaves — the
client never holds table data::

    from repro_torch.serve import D4MClient, TableRef
    from repro_torch.core import StartsWith

    c = D4MClient("http://127.0.0.1:8642")
    A, B = TableRef("edges"), TableRef("feat")
    out = c.query((A[StartsWith("r0"), :] @ B).sum(axis=1))
    out["result"]["vals"]     # the reduced vector
    out["timing"]["exec_s"]   # server-side execution time
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from repro_torch.core.expr import LazyExpr

from .wire import ingest_to_wire, to_wire

__all__ = ["D4MClient", "ServerError"]


class ServerError(Exception):
    """Structured error returned by the server (code + HTTP status)."""

    def __init__(self, status: int, code: str, message: str):
        self.status = status
        self.code = code
        super().__init__(f"[{status}/{code}] {message}")


class D4MClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing -----------------------------------------------------------
    def _request(self, path: str, body: Optional[dict] = None) -> dict:
        url = self.base_url + path
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"} if data else {},
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                err = json.loads(exc.read()).get("error", {})
            except Exception:
                err = {}
            raise ServerError(exc.code, err.get("code", "http_error"),
                              err.get("message", str(exc))) from exc

    # -- API ----------------------------------------------------------------
    def query(self, expr, options: Optional[Dict[str, Any]] = None) -> dict:
        """POST one query; ``expr`` is a TableRef expression or an
        already-serialized wire payload dict."""
        payload = to_wire(expr) if isinstance(expr, LazyExpr) else expr
        body: Dict[str, Any] = {"expr": payload}
        if options:
            body["options"] = options
        return self._request("/query", body)

    def ingest(self, table: str, rows, cols, vals,
               options: Optional[Dict[str, Any]] = None) -> dict:
        """POST one triple batch against a registered ingest table;
        returns ``{"result": {"kind": "ingest", "accepted",
        "delta_depth", "version", ...}, "timing": ...}``."""
        body: Dict[str, Any] = ingest_to_wire(table, rows, cols, vals)
        if options:
            body["options"] = options
        return self._request("/ingest", body)

    def tables(self) -> list:
        return self._request("/tables")["tables"]

    def stats(self) -> dict:
        return self._request("/stats")

    def reset_stats(self) -> dict:
        return self._request("/stats/reset", body={})

    def health(self) -> dict:
        return self._request("/health")
