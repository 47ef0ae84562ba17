"""Roofline terms of one rank's step, and the counts behind them.

There is no HLO here: the file keeps the JAX package's name
(``repro/launch/hlo_analysis.py``) so that a reader finds the counterpart.
The JAX dry run reads XLA's cost analysis and parses the partitioned HLO
(``hlo_static.py``); the port runs the step eagerly, so its three inputs
come from counting what the step executes (:class:`StepCounter`, the
counterpart of ``hlo_static.analyze``):

  * FLOPs: ``torch.utils.flop_counter``'s formulas over every aten op on
    the rank's local tensors, plus the flash kernels' own (their launches
    are invisible to aten counters; ``kernels/flash_attention/ops.py``'s
    ``count_cost`` adds them by the formulas of their bounds);
  * HBM bytes: the input plus output bytes of every aten op executed
    (eager mode: each op is its own round trip to HBM; views and bare
    allocations move nothing), plus the flash kernels';
  * collective bytes: the result bytes of every functional collective that
    DTensor issues, times the JAX ring factors (:data:`_ALGO_FACTOR`), by
    kind.

The counter returns ``NotImplemented`` on DTensor ops, as
``torch.distributed.tensor.debug.CommDebugMode`` does (the tests hold its
collective counts against CommDebugMode's), so DTensor
desugars each into the local ops and collectives that it counts; the
fake-tensor ops of DTensor's shape propagation (global shapes, nothing
run) are not counted.

Hardware model (one H100 SXM of a DGX H100; the mesh's dims cross nodes):
989e12 dense bf16 FLOP/s and 3.35e12 B/s HBM3 (NVIDIA H100 datasheet),
50e9 B/s of collective bandwidth per GPU (one 400 Gb/s NDR InfiniBand port
per GPU, DGX H100 system spec).

``model_flops``, ``active_param_count`` and ``dominant_term`` are the JAX
package's, verbatim.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# -- hardware constants (H100 SXM) --------------------------------------------
PEAK_FLOPS = 989e12         # dense bf16 per GPU (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12            # bytes/s per GPU (HBM3, same datasheet)
NET_BW = 50e9               # bytes/s per GPU: one 400 Gb/s NDR IB port (DGX H100)

# ring-algorithm per-rank byte multipliers (n = group size, large-n limit),
# the JAX package's
_ALGO_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,          # (n-1)/n ≈ 1
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# the functional collectives DTensor issues, by kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ops that allocate and write nothing (no HBM traffic)
_ALLOC_ONLY = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided"})


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class StepCounter(TorchDispatchMode):
    """Counts what the ops run inside the block execute, per rank:
    ``flops``, ``bytes`` (HBM), ``ops``, and the collectives'
    ``collective_bytes`` / ``collective_counts`` by kind.  Enter it around
    one step; the flash kernels' own FLOPs and bytes join in through
    ``count_cost``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collective_bytes = {k: 0.0 for k in _ALGO_FACTOR}
        self.collective_counts = {k: 0 for k in _ALGO_FACTOR}
        self.flash = None
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_by_op: Dict[str, int] = {}

    def __enter__(self):
        from repro_torch.kernels.flash_attention.ops import count_cost
        self._flash_ctx = count_cost()
        self.flash = self._flash_ctx.__enter__().cost
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._flash_ctx.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out    # DTensor's shape propagation: global, not run
        packet = func._overloadpacket
        name = packet.__name__
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        if ns in ("_c10d_functional", "c10d_functional") \
                and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self.collective_counts[kind] += 1
            self.collective_bytes[kind] += \
                _nbytes(_tensors(out)) * _ALGO_FACTOR[kind]
            return out
        if ns in ("_c10d_functional", "c10d_functional"):
            return out                  # wait_tensor and wrappers
        self.ops += 1
        if packet in self._flops:
            n = int(self._flops[packet](*args, **kwargs, out_val=out))
            self.flops += n
            key = f"{name}{[tuple(t.shape) for t in _tensors(args)]}"
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        if not func.is_view and name not in _ALLOC_ONLY:
            n = _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
            self.bytes += n
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + n
        return out

    def result(self) -> Dict[str, Any]:
        """``{"flops", "bytes accessed", "collectives": {"per_kind",
        "counts", "total"}, "ops", "flash": {...}}`` — the flash kernels'
        FLOPs and bytes included in the first two."""
        flash = dict(self.flash or {"flops": 0, "bytes": 0, "launches": 0})
        return {
            "flops": self.flops + flash["flops"],
            "bytes accessed": self.bytes + flash["bytes"],
            "collectives": {"per_kind": dict(self.collective_bytes),
                            "counts": dict(self.collective_counts),
                            "total": sum(self.collective_bytes.values())},
            "ops": self.ops,
            "flash": flash,
            "top_flops": sorted(self.flops_by_op.items(),
                                key=lambda kv: -kv[1])[:12],
            "top_bytes": sorted(self.bytes_by_op.items(),
                                key=lambda kv: -kv[1])[:12],
        }


def collective_bytes(counter: StepCounter) -> Dict[str, Any]:
    """Per-kind per-rank collective bytes (algo-factored), counts and
    total, as the JAX package's ``collective_bytes`` returns them."""
    return counter.result()["collectives"]


def roofline_terms(cost: Dict[str, Any], coll: Dict[str, Any],
                   n_chips: int) -> Dict[str, float]:
    """The three roofline terms in seconds (per step, per rank): the
    counts are one rank's, as the JAX package's post-partitioning counts
    are one device's.  ``n_chips`` is kept for the JAX signature."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    coll_b = float(coll["total"])
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": coll_b / NET_BW,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_hbm,
        "collective_bytes_per_chip": coll_b,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    three = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(three, key=three.get)


def model_flops(cfg, shape, n_active_params: float) -> float:
    """6·N·D (N = active params, D = tokens processed by the step)."""
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * d  # forward only
    return 2.0 * n_active_params * shape.global_batch  # decode: 1 tok/seq


def active_param_count(cfg, total_params: float) -> float:
    """MoE: only top-k experts (+ shared + dense layers) count as active."""
    if not cfg.moe:
        return total_params
    mo = cfg.moe
    d = cfg.d_model
    per_expert = 3 * d * mo["d_ff"]
    n_moe_layers = cfg.n_layers - mo.get("first_dense", 0)
    routed_total = mo["n_experts"] * per_expert * n_moe_layers
    routed_active = mo["top_k"] * per_expert * n_moe_layers
    return total_params - routed_total + routed_active
