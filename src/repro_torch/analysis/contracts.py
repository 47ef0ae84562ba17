"""``@contract`` — declared performance invariants, and their checker.

The decorator attaches a :class:`Contract` to a public API function and
registers it by qualified name, with the fields and defaults of the JAX
package's ``repro.analysis.contracts``::

    @contract(collectives=0, densify=False, name="serve.execute")
    def serve_execute(expr): ...

A contract makes three kinds of claim about every program behind the
entry point:

* ``collectives=N`` — the program's collectives (all-reduce / all-gather /
  all-to-all / collective-permute, a loop's counted once per pass) number
  exactly ``N``.  ``None`` means unchecked.
* ``host_transfers=N`` — host reads inside the program number exactly
  ``N`` (``None`` = unchecked).
* ``densify=False`` — no intermediate exceeds the dense budget
  (``dense_budget`` elems if given, else ``8 ×`` the largest input, floor
  64 Ki — see :meth:`ProgramReport.dense_budget_default`).

The checker *runs* the programs: a probe (:mod:`repro_torch.analysis.probes`)
yields each program behind the entry point as a ``(label, thunk)`` pair,
built from seeded inputs at the JAX probe geometry on the given device and
mesh, and :func:`~repro_torch.analysis.report.trace_call` runs it once and
reports what it did.  Probes may also yield :class:`RetraceAudit` items (a
host cache of the port — the selector compile cache, the plan cache — must
not grow on a repeat call) and :class:`NotRun` items (a program that the
mesh cannot run, with the reason; it is reported, not counted as held).
On the card a program's peak memory (``peak_bytes``) is held too: at most
the dense budget in float32 plus its inputs' bytes, which catches a
workspace an extension allocates outside the ops the checker sees.

The decorator costs one attribute write at import time; the function is
returned unchanged, so the hot path pays nothing.  This module imports
nothing outside the stdlib at module level, so ``core`` can import it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

__all__ = ["CONTRACT_ATTR", "CONTRACT_REGISTRY", "Contract", "NotRun",
           "RetraceAudit", "Violation", "contract", "verify_all",
           "verify_entry"]

CONTRACT_ATTR = "__d4m_contract__"

#: qualified entry name -> Contract
CONTRACT_REGISTRY: Dict[str, "Contract"] = {}


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declared invariants for one API entry point."""
    name: str                                 # registry key (qualname)
    collectives: Optional[int] = None         # exact count
    host_transfers: Optional[int] = 0         # exact count (None=unchecked)
    densify: bool = False                     # True = allowed to densify
    dense_budget: Optional[int] = None        # elems; None = derived default
    note: str = ""                            # one-liner for reports

    def budget(self, report) -> int:
        """The dense budget of one program, in elements."""
        return (self.dense_budget if self.dense_budget is not None
                else report.dense_budget_default())

    def check(self, report, program: str = "") -> List["Violation"]:
        """Check one program's report against this contract."""
        out: List[Violation] = []
        where = f"{self.name}" + (f"[{program}]" if program else "")
        if self.collectives is not None:
            got = report.collectives_total
            if got != self.collectives:
                fams = {k: v for k, v in report.collective_counts.items() if v}
                out.append(Violation(
                    entry=where, kind="collectives",
                    message=(f"expected exactly {self.collectives} "
                             f"collective(s), compiled program has {got:g} "
                             f"{fams or ''}")))
        if self.host_transfers is not None:
            if report.host_transfers != self.host_transfers:
                out.append(Violation(
                    entry=where, kind="host_transfers",
                    message=(f"expected {self.host_transfers} host "
                             f"round-trip(s), compiled program has "
                             f"{report.host_transfers:g}")))
        if not self.densify:
            budget = self.budget(report)
            if report.max_intermediate_elems > budget:
                out.append(Violation(
                    entry=where, kind="densify",
                    message=(f"dense intermediate: "
                             f"{report.max_intermediate_elems} elems "
                             f"({report.max_intermediate_op}) exceeds the "
                             f"tile budget of {budget} elems — the program "
                             f"densifies")))
        return out


@dataclasses.dataclass(frozen=True)
class Violation:
    entry: str
    kind: str          # "collectives" | "host_transfers" | "densify" |
                       # "recompile" | "probe"
    message: str

    def __str__(self) -> str:
        return f"{self.entry}: [{self.kind}] {self.message}"


@dataclasses.dataclass(frozen=True)
class RetraceAudit:
    """A probe's cache claim: ``first()`` and ``again()`` make the same
    call; ``size()`` (a cache's size or miss count) must not grow between
    them."""
    label: str
    first: Callable[[], None]
    again: Callable[[], None]
    size: Callable[[], int]


@dataclasses.dataclass(frozen=True)
class NotRun:
    """A program of the probe that this mesh cannot run, and why."""
    label: str
    reason: str


def contract(collectives: Optional[int] = None,
             host_transfers: Optional[int] = 0,
             densify: bool = False,
             dense_budget: Optional[int] = None,
             note: str = "",
             name: Optional[str] = None):
    """Declare invariants on an API entry point (registers it for
    ``python -m repro_torch.analysis`` and the test sweep; returns ``fn``
    unchanged)."""
    def deco(fn):
        key = name or getattr(fn, "__qualname__", fn.__name__)
        c = Contract(name=key, collectives=collectives,
                     host_transfers=host_transfers, densify=densify,
                     dense_budget=dense_budget, note=note)
        setattr(fn, CONTRACT_ATTR, c)
        CONTRACT_REGISTRY[key] = c
        return fn
    return deco


def _ensure_registry() -> None:
    """Import the decorated modules so their contracts register."""
    import repro_torch.core.assoc_tensor   # noqa: F401
    import repro_torch.core.dist_assoc     # noqa: F401
    import repro_torch.core.spgemm         # noqa: F401
    import repro_torch.ingest.merge        # noqa: F401
    import repro_torch.serve.engine        # noqa: F401


#: ``on_program(entry, label, thunk, result, report, reason)``: called for
#: every program a probe yields — after its counted run (``reason`` None),
#: or with ``thunk``/``result``/``report`` None and the reason it did not run
OnProgram = Callable[..., None]


def verify_entry(name: str, *, device="cuda", mesh=None,
                 on_program: Optional[OnProgram] = None) -> List[Violation]:
    """Check one registered entry point on ``device`` (``"cuda"`` raises
    without a card) and ``mesh`` (default: a one-rank mesh on the device).

    Runs each program its probe yields, counted, and checks the contract;
    also runs the probe's cache audits.  Returns all violations (empty
    list = contract holds).
    """
    from . import probes

    _ensure_registry()
    c = CONTRACT_REGISTRY.get(name)
    if c is None:
        raise KeyError(f"no @contract registered under {name!r}")
    probe = probes.PROBES.get(name)
    if probe is None:
        return [Violation(entry=name, kind="probe",
                          message="no probe registered — contract is "
                                  "declared but unverifiable")]
    from .report import trace_call

    ctx = probes.context(device, mesh)
    out: List[Violation] = []
    for item in probe(ctx):
        if isinstance(item, RetraceAudit):
            item.first()
            before = item.size()
            item.again()
            after = item.size()
            if after != before:
                out.append(Violation(
                    entry=f"{name}[{item.label}]", kind="recompile",
                    message=(f"cache grew {before} -> {after} on an "
                             f"identical repeat call — the cache key is "
                             f"wrong (the work is redone on every call)")))
            continue
        if isinstance(item, NotRun):
            if on_program is not None:
                on_program(name, item.label, None, None, None, item.reason)
            continue
        label, thunk = item
        result, report = trace_call(thunk)
        out.extend(c.check(report, program=label))
        if report.peak_bytes is not None and not c.densify:
            limit = 4 * c.budget(report) + report.input_bytes
            if report.peak_bytes > limit:
                out.append(Violation(
                    entry=f"{name}[{label}]", kind="densify",
                    message=(f"peak device memory {report.peak_bytes} B "
                             f"over the call exceeds the budget's "
                             f"{limit} B (float32 budget + inputs)")))
        if on_program is not None:
            on_program(name, label, thunk, result, report, None)
    return out


def verify_all(names: Optional[List[str]] = None, *, device="cuda",
               mesh=None, on_program: Optional[OnProgram] = None,
               ) -> Dict[str, List[Violation]]:
    """Sweep the whole registry (or the given subset) on ``device`` and
    ``mesh`` (see :func:`verify_entry`).

    Returns ``{entry_name: [violations...]}`` with an entry for every
    checked name, so callers can report clean passes too.  On a mesh of
    several ranks every rank runs the same sweep (its collectives meet)
    and checks its own reports.
    """
    _ensure_registry()
    if names is None:
        names = sorted(CONTRACT_REGISTRY)
    return {n: verify_entry(n, device=device, mesh=mesh,
                            on_program=on_program) for n in names}
