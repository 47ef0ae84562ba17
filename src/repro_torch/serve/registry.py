"""Resident table registry: named associative arrays pinned for serving.

The port of ``repro.serve.registry``.  Tables are loaded ONCE at startup —
from triples files (TSV/CSV ``row<TAB>col<TAB>val`` lines) or generator
configs — and stay resident for the server's lifetime: host ``Assoc`` in
process memory, device ``AssocTensor`` on the registry's device,
``DistAssoc`` row-sharded over the ranks of a mesh.  Queries reference
tables by name through the wire format; the registry is the resolver that
binds :class:`~repro_torch.serve.wire.TableRef` leaves to the resident
arrays, so the planner's ``_PLAN_CACHE`` keys (which include
``id(array)``) are stable across requests and clients.

Spec format (one dict per table, JSON-friendly)::

    {"name": "edges", "path": "edges.tsv", "layer": "device"}
    {"name": "rand",  "generator": "random", "n": 512, "nnz": 4096,
     "seed": 0, "layer": "host"}

``layer`` is ``host`` (default) / ``device`` / ``dist``.  Device tables
live on the registry's ``device`` (``"cuda"`` by default, which raises
without a card; ``"cpu"`` builds on the host).  ``dist`` shards over
``mesh`` (default: :func:`~repro_torch.core.make_mesh`, one rank on the
registry's device).  A registry holds the dist tables of one mesh only,
and under SPMD every rank builds the same registry: each rank holds its
own shards.  ``"ingest": true`` wraps the loaded array in an
:class:`~repro_torch.ingest.IngestTable` so ``POST /ingest`` can mutate
it; queries against an ingest table resolve to its merge-on-read
``snapshot()`` (stable object identity between mutations, so the plan
cache still hits).

A dist table's :meth:`TableRegistry.info` sums ``nnz`` over the shards
with one ``all_reduce`` (counted as a prologue collective: it replaces the
JAX single controller's host read, and is skipped at one rank), so every
rank must call it, in the same order: the engine runs it as a request.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from repro_torch.core.assoc_tensor import resolve_device

from .wire import WireError

__all__ = ["TableRegistry", "load_triples_file", "generate_triples"]


def load_triples_file(path: str):
    """Parse a triples file: one ``row<sep>col<sep>val`` line each
    (separator: tab, or comma when no tab present); ``#`` comments and
    blank lines skipped.  Values parse as float when possible, else
    string."""
    rows: List[str] = []
    cols: List[str] = []
    vals: List[Any] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t") if "\t" in line else line.split(",")
            if len(parts) != 3:
                raise ValueError(
                    f"{path}:{ln}: expected 'row<sep>col<sep>val', got "
                    f"{line!r}")
            rows.append(parts[0].strip())
            cols.append(parts[1].strip())
            vals.append(parts[2].strip())
    try:
        vals_arr: np.ndarray = np.asarray([float(v) for v in vals])
    except ValueError:
        vals_arr = np.asarray(vals, dtype=str)
    return np.asarray(rows, dtype=str), np.asarray(cols, dtype=str), vals_arr


def generate_triples(spec: Dict[str, Any]):
    """Deterministic synthetic tables for benches/demos.

    ``generator="random"``: ``nnz`` triples over an ``n × n`` string
    keyspace.  ``dist="clustered"`` (default) draws keys zipf-ishly so the
    COO has the clustered block structure the BSR planner likes;
    ``"uniform"`` draws uniformly.
    """
    kind = spec.get("generator", "random")
    if kind != "random":
        raise ValueError(f"unknown generator {kind!r}")
    n = int(spec.get("n", 256))
    nnz = int(spec.get("nnz", 4 * n))
    rng = np.random.default_rng(int(spec.get("seed", 0)))
    if spec.get("dist", "clustered") == "clustered":
        # quadratic warp concentrates mass at low ranks (hub keys)
        r = (rng.uniform(0, 1, nnz) ** 2 * n).astype(np.int64) % n
        c = (rng.uniform(0, 1, nnz) ** 2 * n).astype(np.int64) % n
    else:
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, n, nnz)
    width = len(str(max(n - 1, 1)))
    rows = np.asarray([f"r{v:0{width}d}" for v in r])
    cols = np.asarray([f"c{v:0{width}d}" for v in c])
    vals = rng.uniform(0.5, 5.0, nnz)
    return rows, cols, vals


class TableRegistry:
    """Named resident tables + the wire resolver over them.

    ``device``: where device tables are built (``"cuda"`` unless the
    caller passes ``"cpu"``); ``mesh``: the mesh dist tables are sharded
    over (made on first need when not given)."""

    def __init__(self, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self._mesh = mesh
        self._tables: Dict[str, Any] = {}
        self._lock = threading.RLock()

    # -- registration -------------------------------------------------------
    def register(self, name: str, array) -> Any:
        from repro_torch.core import Assoc, AssocTensor, DistAssoc
        from repro_torch.ingest import IngestTable
        if not isinstance(array, (Assoc, AssocTensor, DistAssoc,
                                  IngestTable)):
            raise TypeError(
                f"table {name!r}: expected Assoc/AssocTensor/DistAssoc/"
                f"IngestTable, got {type(array).__name__}")
        base = array.base if isinstance(array, IngestTable) else array
        if isinstance(base, DistAssoc):
            with self._lock:
                mesh = self.dist_mesh()
                if mesh is not None and base.mesh is not mesh:
                    raise ValueError(
                        f"table {name!r}: a registry serves the dist tables "
                        f"of one mesh")
        if isinstance(array, IngestTable) and not array.name:
            array.name = str(name)
        with self._lock:
            self._tables[str(name)] = array
        return array

    def _default_mesh(self):
        """The mesh of a dist spec given none: the registry's (given, or
        its dist tables'), else one rank on the registry's device."""
        if self._mesh is None:
            from repro_torch.core import make_mesh
            self._mesh = self.dist_mesh() or make_mesh(self.device)
        return self._mesh

    def load(self, spec: Dict[str, Any], mesh=None) -> Any:
        """Load one table from a spec dict (``path`` or ``generator``)."""
        name = spec.get("name")
        if not name:
            raise ValueError(f"table spec needs a 'name': {spec!r}")
        if "path" in spec:
            rows, cols, vals = load_triples_file(spec["path"])
        else:
            rows, cols, vals = generate_triples(spec)
        layer = spec.get("layer", "host")
        aggregate = spec.get("aggregate", "sum")
        if layer == "host":
            from repro_torch.core import Assoc
            arr = Assoc(rows, cols, vals, aggregate=aggregate)
        elif layer == "device":
            from repro_torch.core import AssocTensor
            arr = AssocTensor.from_triples(rows, cols, vals,
                                           aggregate=aggregate,
                                           device=self.device)
        elif layer == "dist":
            from repro_torch.core import DistAssoc
            mesh = mesh or self._default_mesh()
            arr = DistAssoc.from_triples(rows, cols, vals, mesh,
                                         aggregate=aggregate,
                                         device=mesh.device)
        else:
            raise ValueError(f"table {name!r}: unknown layer {layer!r}")
        if spec.get("ingest"):
            from repro_torch.ingest import IngestTable
            arr = IngestTable(
                arr, aggregate=aggregate,
                compact_threshold=int(spec.get("compact_threshold", 4096)),
                name=name)
        return self.register(name, arr)

    @classmethod
    def from_specs(cls, specs: Iterable[Dict[str, Any]], mesh=None,
                   device="cuda") -> "TableRegistry":
        reg = cls(device, mesh=mesh)
        for spec in specs:
            reg.load(spec)
        return reg

    # -- lookup -------------------------------------------------------------
    def get(self, name: str):
        with self._lock:
            arr = self._tables.get(str(name))
        if arr is None:
            raise WireError("unknown_table",
                            f"no table registered under {name!r}; "
                            f"known: {self.names()}")
        return arr

    def resolve(self, name: str):
        """The ``from_wire`` resolver.  Plain tables resolve to the
        resident array itself; ingest tables resolve to their current
        merge-on-read :meth:`~repro_torch.ingest.IngestTable.snapshot`
        (memoized per mutation, so ``id(array)`` — and with it every
        plan-cache key — is stable between writes)."""
        from repro_torch.ingest import IngestTable
        arr = self.get(name)
        if isinstance(arr, IngestTable):
            return arr.snapshot()
        return arr

    def dist_mesh(self):
        """The mesh of the registered dist tables, or None when the
        registry holds none (the engine then runs no SPMD mode)."""
        from repro_torch.core import DistAssoc
        from repro_torch.ingest import IngestTable
        with self._lock:
            for a in self._tables.values():
                base = a.base if isinstance(a, IngestTable) else a
                if isinstance(base, DistAssoc):
                    return base.mesh
        return None

    # -- ingest accessors ----------------------------------------------------
    def is_ingest(self, name: str) -> bool:
        from repro_torch.ingest import IngestTable
        return isinstance(self.get(name), IngestTable)

    def ingest_table(self, name: str):
        """The raw :class:`~repro_torch.ingest.IngestTable` (for mutation);
        raises ``WireError("not_ingestable")`` on a read-only table."""
        from repro_torch.ingest import IngestTable
        arr = self.get(name)
        if not isinstance(arr, IngestTable):
            raise WireError(
                "not_ingestable",
                f"table {name!r} is a read-only {type(arr).__name__}; "
                f"register it with ingest=true to accept mutations")
        return arr

    def ingest_names(self) -> List[str]:
        from repro_torch.ingest import IngestTable
        with self._lock:
            return sorted(n for n, a in self._tables.items()
                          if isinstance(a, IngestTable))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def wire_names(self) -> Dict[int, str]:
        """``id(array) -> name`` map for serializing server-side graphs."""
        from repro_torch.ingest import IngestTable
        with self._lock:
            out = {}
            for n, a in self._tables.items():
                out[id(a)] = n
                if isinstance(a, IngestTable):
                    out[id(a.base)] = n
            return out

    def layer_of(self, name: str) -> str:
        from repro_torch.core.plan import _layer
        from repro_torch.ingest import IngestTable
        arr = self.get(name)
        if isinstance(arr, IngestTable):
            arr = arr.base
        return _layer(arr)

    # -- introspection (the /tables endpoint) -------------------------------
    def info(self, name: str) -> Dict[str, Any]:
        """Name, layer, shape, ``nnz`` and value kind of one table (with an
        ingest table's counters); a dist table's costs one collective."""
        from repro_torch.ingest import IngestTable
        arr = self.get(name)
        if isinstance(arr, IngestTable):
            base_info = self._array_info(name, arr.base)
            base_info.update(arr.info())
            return base_info
        return self._array_info(name, arr)

    def _array_info(self, name: str, arr) -> Dict[str, Any]:
        from repro_torch.core import Assoc, AssocTensor, DistAssoc
        from repro_torch.core.collectives import all_reduce
        if isinstance(arr, Assoc):
            return {"name": name, "layer": "host", "shape": list(arr.shape),
                    "nnz": int(arr.nnz()), "numeric": bool(arr.numeric)}
        if isinstance(arr, AssocTensor):
            return {"name": name, "layer": "device",
                    "shape": [len(arr.row_space), len(arr.col_space)],
                    "nnz": int(arr.nnz_host()),
                    "numeric": bool(arr.numeric)}
        if not isinstance(arr, DistAssoc):
            raise TypeError(f"table {name!r}: not an associative array")
        loc = arr.local
        nnz = all_reduce(torch.tensor([int(loc.nnz)], dtype=torch.int64,
                                      device=arr.device), arr.mesh, "sum",
                         prologue=True)
        return {"name": name, "layer": "dist",
                "shape": [len(loc.row_space), len(loc.col_space)],
                "nnz": int(nnz[0]),
                "numeric": bool(loc.numeric),
                "shards": int(arr.mesh.shape["data"])}

    def list_info(self) -> List[Dict[str, Any]]:
        return [self.info(n) for n in self.names()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._tables)

    def __contains__(self, name) -> bool:
        with self._lock:
            return str(name) in self._tables
