"""What one run of a port program did: collectives, host reads, the largest
intermediate — the port's counterpart of the JAX package's
``repro.analysis.hlo_contracts``.

The JAX package checks a contract on the *lowered* program: it walks the
HLO text of a ``jit``/``shard_map`` program and counts what the compiled
program would do.  The port has no compiled program: a port program is a
plain function of one rank's tensors, run op by op.  So
:func:`analyze_call` runs the program once under a
``TorchDispatchMode`` and reads the same three facts off the run:

* **collectives by family** — the delta of
  :data:`repro_torch.core.collectives.COLLECTIVE_STATS` over the call, named
  as the HLO families (``all_reduce`` → ``all-reduce``, ``all_gather`` →
  ``all-gather``, ``all_to_all`` → ``all-to-all``, ``ring_shift`` →
  ``collective-permute``).  A Python loop of N collectives counts N by
  nature, as the JAX walker's trip weighting does.  The prologue's
  collectives (``PROLOGUE_STATS``, the single controller's host reads) and
  the serve engine's control messages (``BROADCAST_STATS``) are not
  program collectives and stay out, as they are absent from the JAX
  programs.  The counters are per rank: on several ranks each rank's
  report is that rank's.
* **host transfers** — what stalls the stream inside the program:
  ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``bool(t)``) and
  any op that takes a CUDA tensor and returns a CPU one (``.cpu()``,
  ``.to("cpu")``, ``.tolist()`` of a CUDA tensor).  On CPU tensors only
  the first kind can be seen; the lint's D4M102 covers the rest in the
  source.  Ops whose output shape depends on the data (``nonzero``,
  boolean indexing) also wait for the card, inside the op, and are not
  counted, as no HLO program has them.
* **the largest intermediate** — the largest ``numel`` of a tensor that an
  aten op returns during the call (views and in-place results alias a
  tensor already counted and are skipped), with the op and shape; the
  densification detector, against :meth:`ProgramReport.dense_budget_default`.
  The dispatch mode sees each tensor an op returns, one at a time; on the
  card :attr:`ProgramReport.peak_bytes` (``torch.cuda.max_memory_allocated``
  over the call) also counts what live intermediates and a kernel
  wrapper's scratch take together.

The JAX module's HLO parser (``parse_hlo``, ``_trip_count``,
``lower_hlo``) has no counterpart here: there is no HLO text to read, no
header dialect and no partitioner custom call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVE_FAMILIES", "ProgramReport", "analyze_call",
           "tensors_in", "trace_call"]

#: the port's collective (``core.collectives``) → the HLO family name
COLLECTIVE_FAMILIES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                       "all_to_all": "all-to-all",
                       "ring_shift": "collective-permute"}


@dataclasses.dataclass
class ProgramReport:
    """What one run of a port program did (the JAX fields, and two the
    card adds)."""
    collective_counts: Dict[str, float]      # family -> count
    host_transfers: float                    # host reads inside the call
    max_intermediate_elems: int              # largest tensor an op returned
    max_intermediate_op: str                 # "op [shape]" of that tensor
    max_input_elems: int                     # largest tensor argument
    while_trip_total: int = 0                # no compiled loop: always 0
    input_bytes: int = 0                     # bytes of the tensor arguments
    peak_bytes: Optional[int] = None         # card memory over the call

    @property
    def collectives_total(self) -> float:
        return sum(self.collective_counts.values())

    def dense_budget_default(self) -> int:
        """Densification threshold when the contract declares none: a COO
        program may pad/stack/concat its inputs but never build anything
        ~O(nr·nc); 8× the biggest input (floor 64 Ki elems) separates the
        two regimes by orders of magnitude for the probe sizes used here."""
        return max(8 * self.max_input_elems, 1 << 16)

    def summary(self) -> str:
        colls = {k: v for k, v in self.collective_counts.items() if v}
        return (f"collectives={self.collectives_total:g} {colls or '{}'} "
                f"host_transfers={self.host_transfers:g} "
                f"max_intermediate={self.max_intermediate_elems} elems "
                f"({self.max_intermediate_op}) "
                f"max_input={self.max_input_elems} elems")


def tensors_in(obj) -> Iterator[torch.Tensor]:
    """Every tensor in ``obj``: tensors, sequences, dicts and the fields of
    dataclasses (an ``AssocTensor``), recursively."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from tensors_in(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors_in(x)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_in(getattr(obj, f.name))


class _Counter(TorchDispatchMode):
    """Host reads and the largest fresh tensor of every aten op."""

    def __init__(self):
        super().__init__()
        self.host_transfers = 0
        self.max_elems = 0
        self.max_op = "none"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten._local_scalar_dense.default:
            self.host_transfers += 1
            return out
        rets = func._schema.returns
        fresh = [t for o, r in zip(out if len(rets) > 1 else (out,), rets)
                 if r.alias_info is None
                 for t in tree_leaves(o) if isinstance(t, torch.Tensor)]
        if fresh and any(o.device.type == "cpu" for o in fresh) and any(
                isinstance(a, torch.Tensor) and a.is_cuda
                for a in tree_leaves((args, kwargs))):
            self.host_transfers += 1
        for o in fresh:
            if o.numel() > self.max_elems:
                self.max_elems = o.numel()
                self.max_op = f"{func} {list(o.shape)}"
        return out


def _program_collectives() -> Dict[str, int]:
    from repro_torch.core.collectives import COLLECTIVE_STATS
    return dict(COLLECTIVE_STATS)


def trace_call(fn, *args, **kwargs) -> Tuple[Any, ProgramReport]:
    """Run ``fn(*args, **kwargs)`` once, counted: ``(its result, its
    report)``.  The inputs are the call's tensor arguments and, for a
    ``functools.partial``, the arguments bound in it."""
    inputs = [args, kwargs]
    if isinstance(fn, functools.partial):
        inputs += [fn.args, fn.keywords]
    ins = list(tensors_in(inputs))
    cuda = next((t.device for t in ins if t.is_cuda), None)
    before = _program_collectives()
    counter = _Counter()
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    with counter:
        out = fn(*args, **kwargs)
    peak = None
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        peak = torch.cuda.max_memory_allocated(cuda) - base
    after = _program_collectives()
    report = ProgramReport(
        collective_counts={fam: float(after[k] - before[k])
                           for k, fam in COLLECTIVE_FAMILIES.items()},
        host_transfers=float(counter.host_transfers),
        max_intermediate_elems=counter.max_elems,
        max_intermediate_op=counter.max_op,
        max_input_elems=max((t.numel() for t in ins), default=0),
        input_bytes=sum(t.numel() * t.element_size() for t in ins),
        peak_bytes=peak)
    return out, report


def analyze_call(fn, *args, **kwargs) -> ProgramReport:
    """The report of one counted run of ``fn(*args, **kwargs)``."""
    return trace_call(fn, *args, **kwargs)[1]
