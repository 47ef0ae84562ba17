"""d4mlint — AST lint for host/device anti-patterns in the port.

The contract checker (:mod:`~repro_torch.analysis.report`) catches what a
probed program does on its probe inputs; this pass catches what is in the
source of every program: host-side Python that reads device values back
or serializes over nnz.  Rules, each an ``ast`` walk over device scopes —
the port's shard and merge programs, named after the JAX package's
``shard_map`` programs: every function whose name ends in ``_prog``, and
every function decorated ``@contract(..., name="dist.…" | "ingest.…")``
(the program contracts of ``core/dist_assoc.py`` and ``ingest/merge.py``),
including their nested defs:

* **D4M101** — host materialization inside a device scope: ``np.*`` /
  ``numpy.*`` calls and ``.numpy()``.  A program computes with torch on
  its rank's device; NumPy on a device tensor copies it to the host.
* **D4M102** — explicit host round trips in a device scope: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize()``
  and ``float()`` / ``int()`` / ``bool()`` of an expression.  Each waits
  for the stream; the contracts declare that the programs never need to.
* **D4M103** — a Python ``for``/``while`` loop over nnz-like bounds
  (``range(... nnz ...)`` …) in a device scope: one launch per entry
  instead of one vectorized sweep.
* **D4M104** — a kernel ``ops.py`` (``src/repro_torch/kernels/*/ops.py``)
  missing the ``"ref"``/``"cuda"``/``"auto"`` dispatch: every kernel entry
  must run on the CPU (``ref``), on the card (``cuda``) and by the
  tensors' device (``auto``).  An ``ops.py`` that passes its ``impl``
  through :func:`repro_torch.kernels.cuda_lib.resolve_impl` (which
  resolves ``"auto"`` and admits ``"cuda"``) dispatches both.

Suppressions::

    # d4mlint: disable=D4M101,D4M103     (file-level, any line)
    some_call()  # d4mlint: ignore[D4M102] reason   (this line only)

Run it: ``python -m repro_torch.analysis.lint [paths...]`` (defaults to
``src/repro_torch``); exits 1 on findings.  ``python -m
repro_torch.analysis`` runs it after the contract sweep.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Set

RULES = {
    "D4M101": "numpy host materialization inside a device scope",
    "D4M102": "host round-trip (item/tolist/cpu/synchronize/int) inside a "
              "device scope",
    "D4M103": "Python loop over nnz inside a device scope",
    "D4M104": "kernel ops.py missing the ref/cuda/auto dispatch",
}

_DISABLE_RE = re.compile(r"#\s*d4mlint:\s*disable=([\w,\s]+)")
_IGNORE_RE = re.compile(r"#\s*d4mlint:\s*ignore\[([\w,\s]+)\]")
_NNZ_NAME = re.compile(r"nnz|n_nz|num_nonzero", re.I)
_PROGRAM_CONTRACTS = ("dist.", "ingest.")
_HOST_METHODS = ("item", "tolist", "cpu")
_IMPLS = ("ref", "cuda", "auto")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# --------------------------------------------------------------------------
# Device-scope discovery
# --------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``np.asarray`` ->
    "np.asarray")."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _is_program_contract(deco: ast.AST) -> bool:
    """``@contract(..., name="dist.…")`` or ``name="ingest.…"``."""
    if not (isinstance(deco, ast.Call)
            and _dotted(deco.func).rsplit(".", 1)[-1] == "contract"):
        return False
    return any(kw.arg == "name" and isinstance(kw.value, ast.Constant)
               and str(kw.value.value).startswith(_PROGRAM_CONTRACTS)
               for kw in deco.keywords)


def _collect_device_scopes(tree: ast.Module) -> Set[ast.AST]:
    """The program defs (``*_prog``, or a program contract) and every def
    or lambda nested in them."""
    scopes = [node for node in ast.walk(tree)
              if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
              and (node.name.endswith("_prog")
                   or any(_is_program_contract(d)
                          for d in node.decorator_list))]
    out: Set[ast.AST] = set()
    for scope in scopes:
        for node in ast.walk(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                out.add(node)
    return out


# --------------------------------------------------------------------------
# Rules
# --------------------------------------------------------------------------

def _host_call(node: ast.Call) -> Optional[str]:
    """Why ``node`` is a host round trip (D4M102), or None."""
    name = _dotted(node.func)
    last = name.rsplit(".", 1)[-1]
    if isinstance(node.func, ast.Attribute):
        if last in _HOST_METHODS:
            return f"`.{last}()`"
        if last == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in [*node.args, *(k.value for k in node.keywords)]):
            return '`.to("cpu")`'
        if name.endswith("cuda.synchronize"):
            return f"`{name}()`"
    elif name in ("float", "int", "bool") and node.args \
            and not isinstance(node.args[0], ast.Constant):
        return f"`{name}(...)` of an expression"
    return None


def _scope_findings(scope: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            parts = name.split(".")
            if parts[0] in ("np", "numpy") and len(parts) > 1:
                out.append(Finding(
                    path, node.lineno, "D4M101",
                    f"`{name}(...)` in a shard program — compute with "
                    f"torch on the rank's device"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "numpy":
                out.append(Finding(
                    path, node.lineno, "D4M101",
                    "`.numpy()` copies a device tensor to the host inside "
                    "a shard program"))
            why = _host_call(node)
            if why:
                out.append(Finding(
                    path, node.lineno, "D4M102",
                    f"{why} forces a host round-trip inside a shard "
                    f"program"))
        elif isinstance(node, (ast.For, ast.While)):
            bound = ""
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Call):
                if _dotted(node.iter.func).rsplit(".", 1)[-1] == "range":
                    bound = ast.dump(node.iter)
            elif isinstance(node, ast.While):
                bound = ast.dump(node.test)
            if bound and _NNZ_NAME.search(bound):
                out.append(Finding(
                    path, node.lineno, "D4M103",
                    "Python loop bounded by nnz in a shard program — one "
                    "launch per entry; vectorize"))
    return out


def _kernel_dispatch_findings(text: str, path: str) -> List[Finding]:
    """D4M104: kernels/*/ops.py must dispatch ref AND cuda AND auto
    (string-literal impl names, or ``resolve_impl`` for cuda and auto)."""
    p = Path(path)
    if p.name != "ops.py" or "kernels" not in p.parts:
        return []
    impls = set(re.findall(r'"(ref|cuda|auto)"', text))
    if re.search(r"\bresolve_impl\(", text):
        impls |= {"cuda", "auto"}
    missing = set(_IMPLS) - impls
    if missing:
        return [Finding(
            path, 1, "D4M104",
            f"kernel dispatch incomplete: no {'/'.join(sorted(missing))} "
            f"path (every kernel needs ref + cuda + auto)")]
    return []


# --------------------------------------------------------------------------
# Running the rules over files
# --------------------------------------------------------------------------

def _suppressions(text: str):
    disabled: Set[str] = set()
    line_ignores = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m:
            disabled.update(r.strip() for r in m.group(1).split(",")
                            if r.strip())
        m = _IGNORE_RE.search(line)
        if m:
            line_ignores[i] = {r.strip() for r in m.group(1).split(",")
                               if r.strip()}
    return disabled, line_ignores


def lint_file(path: str, text: Optional[str] = None) -> List[Finding]:
    if text is None:
        text = Path(path).read_text()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "D4M000",
                        f"syntax error: {e.msg}")]
    disabled, line_ignores = _suppressions(text)

    findings: List[Finding] = []
    seen = set()
    for scope in _collect_device_scopes(tree):
        for f in _scope_findings(scope, path):
            key = (f.line, f.rule, f.message)
            if key not in seen:          # nested scopes overlap
                seen.add(key)
                findings.append(f)
    findings.extend(_kernel_dispatch_findings(text, path))

    return sorted(
        (f for f in findings
         if f.rule not in disabled
         and f.rule not in line_ignores.get(f.line, ())),
        key=lambda f: (f.line, f.rule))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint files / directory trees (``*.py``, recursively)."""
    out: List[Finding] = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            out.extend(lint_file(str(f)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    paths = args or [str(Path(__file__).resolve().parent.parent)]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    print(f"d4mlint: {len(findings)} finding(s) in "
          f"{', '.join(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
