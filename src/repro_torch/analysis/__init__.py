"""repro_torch.analysis — the D4M performance contracts, declared and checked
on the port (module step 8; the JAX package's ``repro.analysis``).

The paper's performance story rests on structural invariants the layer
docstrings only *state*: shard-local paths run with **zero collectives**,
selection **never densifies**, the fused spgemm epilogues spend exactly
**one** reduction.  This package checks those claims on every program
behind a declared entry point, by running it:

* :mod:`~repro_torch.analysis.report` — runs one program under a torch
  dispatch mode and the collective counters and reports its collectives
  by family, host reads and largest intermediate (the JAX package reads
  these off the HLO of the lowered program; the HLO walker has no
  counterpart here).
* :mod:`~repro_torch.analysis.contracts` — the ``@contract(...)``
  decorator and registry declaring the invariants at the API (the same 24
  declarations as the JAX package's), plus the checker that sweeps them.
* :mod:`~repro_torch.analysis.probes` — per-entry-point probes that build
  each decorated API's programs over seeded inputs on a device and mesh.
* :mod:`~repro_torch.analysis.lint` — the host-side AST lint forbidding
  known anti-patterns (host reads inside shard programs, Python loops over
  nnz, kernels missing the ref/cuda/auto dispatch).

``python -m repro_torch.analysis`` and the ``tests/test_torch_contracts.py``
sweep are the two consumers; both fail on any contract violation or lint
finding.

Only :mod:`.contracts` loads with the package (``core`` imports its
decorator); the rest load on first use.
"""
from .contracts import (CONTRACT_ATTR, CONTRACT_REGISTRY, Contract, NotRun,
                        RetraceAudit, Violation, contract, verify_all,
                        verify_entry)

_LAZY = {"ProgramReport": "report", "analyze_call": "report",
         "trace_call": "report", "Finding": "lint", "lint_file": "lint",
         "lint_paths": "lint"}


def __getattr__(name):
    # report imports torch and core, lint loads apart so that
    # `python -m repro_torch.analysis.lint` doesn't import it twice
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)


__all__ = [
    "contract", "Contract", "CONTRACT_ATTR", "CONTRACT_REGISTRY", "NotRun",
    "RetraceAudit", "Violation", "verify_entry", "verify_all",
    "ProgramReport", "analyze_call", "trace_call",
    "Finding", "lint_file", "lint_paths",
]
