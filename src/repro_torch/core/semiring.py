"""Semiring algebra for associative arrays.

A semiring ``(V, ⊕, ⊗, 0, 1)`` supplies the addition/multiplication pair under
which associative-array algebra (element-wise add, element-wise multiply, and
array multiplication ``⊗.⊕``) is defined.  This module provides the registry
of the semirings used by D4M plus the machinery the device kernels dispatch
on.

Two families of implementations coexist:

* **scalar/numpy** callables (``add_np`` / ``mul_np`` and the ``*_py``
  views) used by the host ``Assoc`` and by property tests of the axioms;
* **torch** callables (``add`` / ``mul`` / ``add_reduce``) that operate on
  tensors on any device.  The hand-written CUDA kernels take the semiring
  by name (``name``) and instantiate the matching ⊕/⊗/zero template.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = [
    "Semiring",
    "PLUS_TIMES",
    "MAX_PLUS",
    "MIN_PLUS",
    "MAX_MIN",
    "MAX_TIMES",
    "AND_OR",
    "get_semiring",
    "scatter_combine",
    "REGISTRY",
]

# k-slab depth of the broadcast-reduce contraction: [M, 32, N] products are
# materialized per slab, never the whole [M, K, N] cube
_SLAB = 32


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (numerical) semiring usable on both host and device.

    Attributes
    ----------
    name:       registry key, e.g. ``"plus_times"``.
    add:        torch elementwise ⊕ (associative & commutative).
    mul:        torch elementwise ⊗ (associative; distributes over ⊕).
    zero:       identity of ⊕ / annihilator of ⊗ (python float).
    one:        identity of ⊗ (python float).
    add_reduce: ``add_reduce(x, axis=None)`` — ⊕ along an axis (all axes
                when ``axis`` is None).
    add_np:     numpy ufunc mirror of ⊕ (host ``Assoc`` algebra and the
                canonical COO merge's ``reduceat`` fast path).
    mul_np:     numpy ufunc mirror of ⊗.
    mxu:        True iff the contraction is a plain multiply-accumulate
                float matmul (only the plus-times algebra qualifies).
    idempotent_add: True iff ``a ⊕ a == a`` (max/min-style algebras).
    add_kind:   the ⊕ monoid family — ``"sum"``, ``"max"`` or ``"min"``;
                it selects the native scatter reduction
                (:func:`scatter_combine`).
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Any], Any]
    zero: float
    one: float
    add_reduce: Callable[..., Any]
    add_np: Callable[[Any, Any], Any] = np.add
    mul_np: Callable[[Any, Any], Any] = np.multiply
    mxu: bool = False
    idempotent_add: bool = False
    add_kind: str = "sum"

    # ---- host/scalar views (numpy-friendly; used by host Assoc + tests) ----
    def add_py(self, a, b):
        return np.asarray(self.add_np(np.asarray(a), np.asarray(b)))[()]

    def mul_py(self, a, b):
        return np.asarray(self.mul_np(np.asarray(a), np.asarray(b)))[()]

    def matmul_dense(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Plain dense contraction ``C[i,j] = ⊕_k a[i,k] ⊗ b[k,j]`` (fp32).

        ``(+,×)`` is one float32 matmul; every other semiring broadcasts
        ⊗ over 32-deep k-slabs and ⊕-reduces each slab into the result.
        """
        a = a.to(torch.float32)
        b = b.to(torch.float32)
        if self.mxu:
            return torch.matmul(a, b)
        out = None
        for k0 in range(0, a.shape[1], _SLAB):
            prod = self.mul(a[:, k0:k0 + _SLAB, None], b[None, k0:k0 + _SLAB, :])
            part = self.add_reduce(prod, axis=1)
            out = part if out is None else self.add(out, part)
        if out is None:   # K == 0: the empty ⊕
            out = torch.full((a.shape[0], b.shape[1]), self.zero,
                             dtype=torch.float32, device=a.device)
        return out

    def is_zero(self, x) -> Any:
        if math.isinf(self.zero):
            return torch.isinf(x) & ((x < 0) == (self.zero < 0))
        return x == self.zero


def _sum(x, axis=None):
    return x.sum() if axis is None else x.sum(dim=axis)


def _amax(x, axis=None):
    return x.amax() if axis is None else x.amax(dim=axis)


def _amin(x, axis=None):
    return x.amin() if axis is None else x.amin(dim=axis)


def _mk(name, add, mul, zero, one, add_reduce, add_np, mul_np,
        mxu=False, idem=False, kind="sum") -> Semiring:
    return Semiring(
        name=name, add=add, mul=mul, zero=zero, one=one,
        add_reduce=add_reduce, add_np=add_np, mul_np=mul_np,
        mxu=mxu, idempotent_add=idem, add_kind=kind,
    )


PLUS_TIMES = _mk(
    "plus_times", torch.add, torch.mul, 0.0, 1.0, _sum,
    np.add, np.multiply, mxu=True, kind="sum")
MAX_PLUS = _mk(
    "max_plus", torch.maximum, torch.add, -math.inf, 0.0, _amax,
    np.maximum, np.add, idem=True, kind="max")
MIN_PLUS = _mk(
    "min_plus", torch.minimum, torch.add, math.inf, 0.0, _amin,
    np.minimum, np.add, idem=True, kind="min")
MAX_MIN = _mk(
    "max_min", torch.maximum, torch.minimum, -math.inf, math.inf, _amax,
    np.maximum, np.minimum, idem=True, kind="max")
MAX_TIMES = _mk(
    "max_times", torch.maximum, torch.mul, 0.0, 1.0, _amax,
    np.maximum, np.multiply, idem=True, kind="max")
# Boolean algebra on {0., 1.}: on this domain ∨ ≡ max and ∧ ≡ min, and the
# max/min forms stay in floating point so one code path (and one canonical
# COO merge) serves every semiring on host and device alike.
AND_OR = _mk(
    "and_or", torch.maximum, torch.minimum, 0.0, 1.0, _amax,
    np.maximum, np.minimum, idem=True, kind="max")

_SCATTER_REDUCE = {"sum": "sum", "max": "amax", "min": "amin"}


def scatter_combine(vec: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    sr: Semiring, *, mode: str = "drop") -> torch.Tensor:
    """Segment-⊕ ``vals`` into ``vec`` at ``idx`` along ``vec``'s first axis
    with the semiring's native ``scatter_reduce_`` (sum / amax / amin).

    ``vec`` must be pre-filled with ``sr.zero`` (the scatter is a pure
    ⊕-merge, ``include_self=True``); ``vals`` has shape
    ``idx.shape + vec.shape[1:]``.  A negative index counts from the end;
    indices still outside ``[0, len(vec))`` (sentinels, padding) are
    dropped: they are routed to one extra slot that is cut off, because
    ``scatter_reduce_`` raises on them.  Returns a new tensor; ``vec`` is
    left as it was.
    """
    if mode != "drop":
        raise ValueError(f"unsupported scatter mode {mode!r}")
    n = vec.shape[0]
    rest = tuple(vec.shape[1:])
    idx = idx.reshape(-1).to(torch.int64)
    vals = vals.reshape((idx.shape[0],) + rest).to(vec.dtype)
    idx = torch.where(idx < 0, idx + n, idx)     # negative: from the end
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([vec, vec.new_full((1,) + rest, sr.zero)])
    index = idx.view((-1,) + (1,) * len(rest)).expand_as(vals)
    out.scatter_reduce_(0, index, vals, reduce=_SCATTER_REDUCE[sr.add_kind],
                        include_self=True)
    return out[:n]


REGISTRY: Dict[str, Semiring] = {
    s.name: s
    for s in (PLUS_TIMES, MAX_PLUS, MIN_PLUS, MAX_MIN, MAX_TIMES, AND_OR)
}


def get_semiring(name_or_sr) -> Semiring:
    if isinstance(name_or_sr, Semiring):
        return name_or_sr
    try:
        return REGISTRY[str(name_or_sr)]
    except KeyError as exc:
        raise KeyError(
            f"unknown semiring {name_or_sr!r}; known: {sorted(REGISTRY)}"
        ) from exc


# ---------------------------------------------------------------------------
# The (nonunital) string algebra (Σ*, ⌢, min, ε) — host only.
#
# String values cannot live on a device; the device stores int32 ranks into
# the sorted unique-value array (the paper's own pointer scheme).  min under
# the dictionary order is then rank-min (device-safe); concatenation creates
# new values and therefore runs on host where the dictionary can grow.
# ---------------------------------------------------------------------------

class StringAlgebra:
    """The paper's nonunital string semiring: ⊕ = concatenation, ⊗ = min."""

    name = "string"
    zero = ""  # ε — identity for concatenation, the "empty" value

    @staticmethod
    def add_py(a: str, b: str) -> str:
        return a + b

    @staticmethod
    def mul_py(a: str, b: str) -> str:
        return min(a, b)


STRING = StringAlgebra()
