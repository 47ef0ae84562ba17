"""Expression wire format: LazyExpr graphs + Selector trees ⇄ JSON.

The port of ``repro.serve.wire``, framework-neutral as it is: the same
``WIRE_VERSION`` and the same JSON, so a client of either package talks
to a server of either.

Clients do not hold table data — they build expressions over
:class:`TableRef` leaves (``TableRef("edges")[sel, :] @ TableRef("feat")``)
and ship the *graph*.  The payload is a flat node list in topological
order::

    {"version": 1,
     "nodes": [{"op": "table", "name": "edges"},
               {"op": "select", "child": 0, "row": {...}, "col": {...}},
               {"op": "matmul", "a": 1, "b": 1, "semiring": "plus_times"}],
     "root": 2}

Design rules, all load-bearing for the server:

* **References point backwards.**  A node may only reference earlier list
  positions; a forward or self reference is rejected as a cycle (an
  expression DAG serialized by :func:`to_wire` is always topological, so
  any violation means a malformed/adversarial payload, not a bug here).
* **Shared subtrees serialize once.**  :func:`to_wire` hash-conses on the
  structural ``key()``, so a repeated subexpression is one node referenced
  twice — and deserializes back into one shared node, keeping the
  planner's hash-consing effective server-side.
* **Semirings travel by registry name**, tables by registry name; both
  resolve (or fail with a structured :class:`WireError`) at decode time.
* **No code crosses the wire.**  ``Where`` predicates are referenced by a
  server-registered name (:func:`register_predicate`); an unregistered
  callable is rejected at *serialization* time, and an unknown name at
  decode time.  Nothing in a payload is ever evaluated.

Every decode error raises :class:`WireError` with a machine-readable
``code`` (``unknown_table``, ``unknown_semiring``, ``cycle``,
``bad_payload``, …) so the HTTP layer can return structured 400s
instead of 500s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.expr import (EwiseAdd, EwiseMul, LazyExpr, MatMul,
                                   Reduce, Select, Source, Transpose)
from repro_torch.core.select import (All, And, Keys, Mask, Match, Not, Or,
                                     Positions, Range, Selector, StartsWith,
                                     Where, as_selector)
from repro_torch.core.semiring import get_semiring

__all__ = ["WIRE_VERSION", "WireError", "TableRef", "to_wire", "from_wire",
           "sel_to_wire", "sel_from_wire", "register_predicate",
           "table_names", "ingest_to_wire", "ingest_from_wire"]

WIRE_VERSION = 1


class WireError(ValueError):
    """Structured wire-format rejection: ``code`` is machine-readable."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)

    def to_dict(self) -> dict:
        return {"code": self.code, "message": str(self)}


class TableRef(LazyExpr):
    """Expression leaf naming a resident server table (no data attached).

    Clients compose queries over these; the server's decoder rebinds them
    to the registry's resident arrays.
    """

    def __init__(self, name: str):
        self.name = str(name)

    def key(self) -> tuple:
        return ("table", self.name)

    def __repr__(self) -> str:
        return f"TableRef({self.name!r})"


# ---------------------------------------------------------------------------
# Named predicates (the only way a Where crosses the wire)
# ---------------------------------------------------------------------------

_PREDICATES: Dict[str, Callable] = {}
_PREDICATE_NAMES: Dict[int, str] = {}


def register_predicate(name: str, fn: Callable) -> Callable:
    """Register a ``Where`` predicate under a wire-safe name (both sides
    of the wire must register the same name to round-trip)."""
    _PREDICATES[str(name)] = fn
    _PREDICATE_NAMES[id(fn)] = str(name)
    return fn


# ---------------------------------------------------------------------------
# Selector ⇄ JSON
# ---------------------------------------------------------------------------

def _keylist(arr: np.ndarray) -> list:
    return [str(k) for k in arr] if arr.dtype.kind in ("U", "S", "O") \
        else [float(k) for k in arr]


def sel_to_wire(sel) -> dict:
    """Serialize any selector argument (Selector instance or raw
    ``__getitem__`` form: strings, ints, slices, arrays, 2-tuples)."""
    try:
        s = as_selector(sel)
    except TypeError as exc:
        raise WireError("bad_selector",
                        f"not a serializable selector: {sel!r} ({exc})")
    if isinstance(s, All):
        return {"sel": "all"}
    if isinstance(s, Keys):
        return {"sel": "keys", "keys": _keylist(s.keys)}
    if isinstance(s, Positions):
        if isinstance(s.pos, slice):
            return {"sel": "positions",
                    "slice": [s.pos.start, s.pos.stop, s.pos.step]}
        return {"sel": "positions", "pos": [int(p) for p in s.pos]}
    if isinstance(s, Range):
        def bound(x):
            return None if x is None else (
                str(x) if isinstance(x, str) else float(x))
        return {"sel": "range", "lo": bound(s.lo), "hi": bound(s.hi),
                "inclusive": list(s.inclusive)}
    if isinstance(s, StartsWith):
        return {"sel": "startswith", "prefixes": list(s.prefixes)}
    if isinstance(s, Match):
        return {"sel": "match", "pattern": s.pattern, "flags": int(s.flags)}
    if isinstance(s, Mask):
        return {"sel": "mask", "bits": [bool(b) for b in s.bits]}
    if isinstance(s, Where):
        name = _PREDICATE_NAMES.get(id(s.fn))
        if name is None:
            raise WireError(
                "unserializable_selector",
                "Where predicates cross the wire by registered name only "
                "(register_predicate); arbitrary callables do not "
                "serialize")
        return {"sel": "where", "name": name}
    if isinstance(s, (And, Or)):
        return {"sel": "and" if isinstance(s, And) else "or",
                "a": sel_to_wire(s.a), "b": sel_to_wire(s.b)}
    if isinstance(s, Not):
        return {"sel": "not", "a": sel_to_wire(s.a)}
    raise WireError("bad_selector",
                    f"unknown selector type {type(s).__name__}")


def sel_from_wire(d: Any) -> Selector:
    """Decode a selector wire dict; raises WireError on malformed input."""
    if not isinstance(d, dict) or "sel" not in d:
        raise WireError("bad_payload",
                        f"selector must be a dict with a 'sel' tag, "
                        f"got {type(d).__name__}")
    kind = d["sel"]
    try:
        if kind == "all":
            return All()
        if kind == "keys":
            return Keys(list(d["keys"]))
        if kind == "positions":
            if "slice" in d:
                start, stop, step = d["slice"]
                return Positions(slice(start, stop, step))
            return Positions([int(p) for p in d["pos"]])
        if kind == "range":
            inc = d.get("inclusive", [True, True])
            return Range(d.get("lo"), d.get("hi"),
                         inclusive=(bool(inc[0]), bool(inc[1])))
        if kind == "startswith":
            return StartsWith([str(p) for p in d["prefixes"]])
        if kind == "match":
            return Match(str(d["pattern"]), int(d.get("flags", 0)))
        if kind == "mask":
            return Mask([bool(b) for b in d["bits"]])
        if kind == "where":
            fn = _PREDICATES.get(str(d.get("name")))
            if fn is None:
                raise WireError(
                    "unknown_predicate",
                    f"no predicate registered under {d.get('name')!r}")
            return Where(fn)
        if kind in ("and", "or"):
            a, b = sel_from_wire(d["a"]), sel_from_wire(d["b"])
            return And(a, b) if kind == "and" else Or(a, b)
        if kind == "not":
            return Not(sel_from_wire(d["a"]))
    except WireError:
        raise
    except Exception as exc:   # malformed fields, bad regex, wrong types
        raise WireError("bad_payload",
                        f"malformed {kind!r} selector: {exc}") from exc
    raise WireError("bad_selector", f"unknown selector kind {kind!r}")


# ---------------------------------------------------------------------------
# Expression graph ⇄ JSON
# ---------------------------------------------------------------------------

def to_wire(expr: LazyExpr, names: Optional[Dict[int, str]] = None) -> dict:
    """Serialize an expression graph to the wire payload.

    ``TableRef`` leaves carry their own name; ``Source`` leaves (server-
    side graphs over resident arrays) need ``names`` mapping
    ``id(array) -> table name``.  Shared subtrees (same structural key)
    serialize once and are referenced by node id.
    """
    if not isinstance(expr, LazyExpr):
        raise WireError("bad_payload",
                        f"not an expression: {type(expr).__name__}")
    nodes: List[dict] = []
    index: Dict[tuple, int] = {}

    def visit(node: LazyExpr) -> int:
        k = node.key()
        if k in index:
            return index[k]
        if isinstance(node, TableRef):
            d = {"op": "table", "name": node.name}
        elif isinstance(node, Source):
            name = (names or {}).get(id(node.array))
            if name is None:
                raise WireError(
                    "unknown_table",
                    "Source array has no table name; pass names={id(a): "
                    "name} or build the graph over TableRef leaves")
            d = {"op": "table", "name": name}
        elif isinstance(node, Select):
            d = {"op": "select", "child": visit(node.child),
                 "row": sel_to_wire(node.row_sel),
                 "col": sel_to_wire(node.col_sel)}
        elif isinstance(node, (EwiseAdd, EwiseMul, MatMul)):
            d = {"op": node.tag, "a": visit(node.a), "b": visit(node.b),
                 "semiring": node.semiring.name}
        elif isinstance(node, Reduce):
            d = {"op": "reduce", "child": visit(node.child),
                 "axis": node.axis, "semiring": node.semiring.name}
        elif isinstance(node, Transpose):
            d = {"op": "transpose", "child": visit(node.child)}
        else:
            raise WireError("bad_payload",
                            f"node type {type(node).__name__} does not "
                            f"serialize (planner-internal node?)")
        nid = len(nodes)
        nodes.append(d)
        index[k] = nid
        return nid

    root = visit(expr)
    return {"version": WIRE_VERSION, "nodes": nodes, "root": root}


def _ref(d: dict, field: str, pos: int, decoded: list) -> LazyExpr:
    """Resolve a child reference: must be an int pointing at an EARLIER
    node — forward/self references cannot arise from a DAG and are
    rejected as cycles."""
    ref = d.get(field)
    if not isinstance(ref, int) or isinstance(ref, bool):
        raise WireError("bad_payload",
                        f"node {pos}: field {field!r} must be an int node "
                        f"id, got {ref!r}")
    if ref < 0 or ref >= len(decoded) or ref >= pos:
        if 0 <= ref < pos or ref < 0:
            raise WireError("bad_payload",
                            f"node {pos}: reference {ref} out of range")
        raise WireError("cycle",
                        f"node {pos}: reference {ref} is not an earlier "
                        f"node — the payload graph has a cycle or forward "
                        f"reference")
    return decoded[ref]


def _semiring(d: dict, pos: int):
    name = d.get("semiring", "plus_times")
    try:
        return get_semiring(name)
    except KeyError as exc:
        raise WireError("unknown_semiring", str(exc)) from exc


def from_wire(payload: Any,
              resolve: Optional[Callable[[str], Any]] = None) -> LazyExpr:
    """Decode a wire payload into an expression graph.

    ``resolve(name) -> array`` binds table leaves to resident arrays
    (server side); ``resolve=None`` keeps them as :class:`TableRef`
    placeholders (client-side round trip).  Raises :class:`WireError`
    with a structured code on any malformed input.
    """
    if not isinstance(payload, dict):
        raise WireError("bad_payload",
                        f"payload must be a dict, got "
                        f"{type(payload).__name__}")
    if payload.get("version") != WIRE_VERSION:
        raise WireError("bad_version",
                        f"unsupported wire version "
                        f"{payload.get('version')!r} (expected "
                        f"{WIRE_VERSION})")
    nodes = payload.get("nodes")
    if not isinstance(nodes, list) or not nodes:
        raise WireError("bad_payload", "payload needs a nonempty 'nodes' "
                                       "list")
    decoded: List[LazyExpr] = []
    for pos, d in enumerate(nodes):
        if not isinstance(d, dict) or "op" not in d:
            raise WireError("bad_payload",
                            f"node {pos} must be a dict with an 'op' tag")
        op = d["op"]
        if op == "table":
            name = d.get("name")
            if not isinstance(name, str) or not name:
                raise WireError("bad_payload",
                                f"node {pos}: table node needs a string "
                                f"'name'")
            if resolve is None:
                decoded.append(TableRef(name))
            else:
                decoded.append(Source(resolve(name)))
        elif op == "select":
            child = _ref(d, "child", pos, decoded)
            decoded.append(Select(child, sel_from_wire(d.get("row")),
                                  sel_from_wire(d.get("col"))))
        elif op in ("ewise_add", "ewise_mul", "matmul"):
            a = _ref(d, "a", pos, decoded)
            b = _ref(d, "b", pos, decoded)
            cls = {"ewise_add": EwiseAdd, "ewise_mul": EwiseMul,
                   "matmul": MatMul}[op]
            decoded.append(cls(a, b, semiring=_semiring(d, pos)))
        elif op == "reduce":
            child = _ref(d, "child", pos, decoded)
            axis = d.get("axis")
            if axis not in (None, 0, 1):
                raise WireError("bad_payload",
                                f"node {pos}: reduce axis must be null, 0 "
                                f"or 1, got {axis!r}")
            decoded.append(Reduce(child, axis,
                                  semiring=_semiring(d, pos)))
        elif op == "transpose":
            decoded.append(Transpose(_ref(d, "child", pos, decoded)))
        else:
            raise WireError("unknown_op", f"node {pos}: unknown op {op!r}")
    root = payload.get("root")
    if not isinstance(root, int) or isinstance(root, bool) \
            or not (0 <= root < len(decoded)):
        raise WireError("bad_payload",
                        f"'root' must be a valid node id, got {root!r}")
    return decoded[root]


# ---------------------------------------------------------------------------
# Ingest batches ⇄ JSON (the POST /ingest payload)
# ---------------------------------------------------------------------------

def ingest_to_wire(table: str, rows, cols, vals) -> dict:
    """Serialize one triple batch against a registry ingest table::

        {"version": 1,
         "ingest": {"table": "edges",
                    "rows": [...], "cols": [...], "vals": [...]}}

    Keys may be strings or numbers; values must be numbers for device/
    dist tables (the server enforces the layer rule at insert time).
    """
    def _k(x):
        return str(x) if isinstance(x, str) or (
            hasattr(x, "dtype") and np.asarray(x).dtype.kind in "USO") \
            else float(x)

    return {"version": WIRE_VERSION,
            "ingest": {"table": str(table),
                       "rows": [_k(x) for x in rows],
                       "cols": [_k(x) for x in cols],
                       "vals": [str(v) if isinstance(v, str) else float(v)
                                for v in vals]}}


def _ingest_axis(batch: dict, field: str) -> np.ndarray:
    xs = batch.get(field)
    if not isinstance(xs, list) or not xs:
        raise WireError("bad_batch",
                        f"ingest batch needs a nonempty {field!r} list")
    if all(isinstance(x, str) for x in xs):
        return np.asarray(xs, dtype=str)
    if all(isinstance(x, (int, float)) and not isinstance(x, bool)
           for x in xs):
        return np.asarray(xs, dtype=np.float64)
    raise WireError("bad_batch",
                    f"ingest batch {field!r} must be all-string or "
                    f"all-numeric scalars")


def ingest_from_wire(payload: Any):
    """Decode + validate an ingest payload → ``(table, rows, cols, vals)``
    numpy arrays.  Raises :class:`WireError` (code ``bad_batch`` for a
    malformed batch) — invalid batches never reach the engine queue."""
    if not isinstance(payload, dict):
        raise WireError("bad_payload",
                        f"payload must be a dict, got "
                        f"{type(payload).__name__}")
    if payload.get("version") != WIRE_VERSION:
        raise WireError("bad_version",
                        f"unsupported wire version "
                        f"{payload.get('version')!r} (expected "
                        f"{WIRE_VERSION})")
    batch = payload.get("ingest")
    if not isinstance(batch, dict):
        raise WireError("bad_payload",
                        "ingest payload needs an 'ingest' dict")
    name = batch.get("table")
    if not isinstance(name, str) or not name:
        raise WireError("bad_batch",
                        "ingest batch needs a string 'table' name")
    rows = _ingest_axis(batch, "rows")
    cols = _ingest_axis(batch, "cols")
    vals = _ingest_axis(batch, "vals")
    if not (len(rows) == len(cols) == len(vals)):
        raise WireError("bad_batch",
                        f"rows/cols/vals must have equal length, got "
                        f"{len(rows)}/{len(cols)}/{len(vals)}")
    return name, rows, cols, vals


def table_names(payload: Any) -> tuple:
    """The sorted table names a (structurally valid) payload references —
    the admission-batching compatibility key, computable without binding
    any arrays."""
    if not isinstance(payload, dict) or not isinstance(
            payload.get("nodes"), list):
        raise WireError("bad_payload", "payload must be a dict with a "
                                       "'nodes' list")
    out = set()
    for d in payload["nodes"]:
        if isinstance(d, dict) and d.get("op") == "table":
            name = d.get("name")
            if isinstance(name, str):
                out.add(name)
    return tuple(sorted(out))
