"""Lazy D4M expressions: the deferred composition API over every layer.

D4M's exemplar queries are one-liners that *chain* selection, element-wise
⊕/⊗ and array multiplication — and D4M 3.0 showed the big wins come from
deferring evaluation of such chains so the work can be pushed into the
multiply.  This module is the expression half of that design:

* a small algebra of graph nodes — :class:`Source`, :class:`Select`,
  :class:`EwiseAdd`/:class:`EwiseMul`, :class:`MatMul`, :class:`Reduce`,
  :class:`Transpose` — each carrying its own ``semiring``;
* ``A.lazy()`` on ``Assoc``/``AssocTensor`` wraps the array
  in a :class:`Source`; from there the usual operators **build the graph
  instead of executing**:  ``A.lazy()[sel] @ B.lazy()[sel]`` is a three-node
  expression, not two slices and a product;
* ``.collect()`` hands the graph to the planner
  (:mod:`repro_torch.core.plan`), which rewrites it — selector pushdown,
  ``MatMul→Reduce`` fusion onto the spgemm epilogues, ewise-chain
  fusion, hash-consed repeated subtrees — and then executes the optimized
  program on whichever layer the sources live on.

The eager APIs are thin wrappers over this module: ``A + B`` builds a
one-node :class:`EwiseAdd` graph and collects it immediately, so lazy and
eager are one code path with one semantics, not two parallel
implementations.
"""
from __future__ import annotations

from typing import Any, Optional

from .select import as_selector
from .semiring import PLUS_TIMES, get_semiring

__all__ = [
    "LazyExpr", "Source", "Select", "EwiseAdd", "EwiseMul", "MatMul",
    "Reduce", "Transpose", "lazy",
]


def lazy(x) -> "LazyExpr":
    """Wrap an associative array (any layer) as an expression Source;
    expression nodes pass through unchanged."""
    if isinstance(x, LazyExpr):
        return x
    return Source(x)


def _sel_key(sel) -> tuple:
    """Structural identity of a selector argument (for hash-consing).

    Falls back to object identity for uncacheable selectors (``Where``
    closures) — still stable within one ``collect()``.
    """
    try:
        return as_selector(sel).cache_key()
    except TypeError:
        return ("id", id(sel))


class LazyExpr:
    """Base expression node: deferred, composable, layer-agnostic.

    Nodes are immutable; building one never touches array data.  The
    operators mirror the eager associative-array API exactly — plus the
    explicit ``add``/``mul``/``matmul``/``sum`` forms that take a
    ``semiring=``.
    """

    __array_priority__ = 200  # beat numpy AND the eager Assoc in binary ops

    semiring = PLUS_TIMES

    # -- graph building -----------------------------------------------------
    def __getitem__(self, ij) -> "Select":
        i, j = ij
        return Select(self, i, j)

    def add(self, other, semiring=PLUS_TIMES) -> "EwiseAdd":
        return EwiseAdd(self, lazy(other), semiring=semiring)

    def mul(self, other, semiring=PLUS_TIMES) -> "EwiseMul":
        return EwiseMul(self, lazy(other), semiring=semiring)

    def matmul(self, other, semiring=PLUS_TIMES) -> "MatMul":
        return MatMul(self, lazy(other), semiring=semiring)

    def __add__(self, other) -> "EwiseAdd":
        return EwiseAdd(self, lazy(other))

    def __radd__(self, other) -> "EwiseAdd":
        return EwiseAdd(lazy(other), self)

    def __mul__(self, other) -> "EwiseMul":
        return EwiseMul(self, lazy(other))

    def __rmul__(self, other) -> "EwiseMul":
        return EwiseMul(lazy(other), self)

    def __matmul__(self, other) -> "MatMul":
        return MatMul(self, lazy(other))

    def __rmatmul__(self, other) -> "MatMul":
        return MatMul(lazy(other), self)

    def sum(self, axis: Optional[int] = None, semiring=PLUS_TIMES) -> "Reduce":
        """⊕-reduction: ``axis=1`` → vector over rows, ``axis=0`` → vector
        over cols, ``axis=None`` → scalar ⊕ over every entry."""
        return Reduce(self, axis, semiring=semiring)

    reduce = sum

    def transpose(self) -> "Transpose":
        return Transpose(self)

    @property
    def T(self) -> "Transpose":
        return self.transpose()

    def sqin(self, semiring=PLUS_TIMES,
             reduce: Optional[int] = None) -> "LazyExpr":
        """AᵀA as a graph — the planner collapses ``reduce=0/1`` onto the
        fused spgemm epilogue."""
        sq = MatMul(Transpose(self), self, semiring=semiring)
        return sq if reduce is None else Reduce(sq, reduce, semiring=semiring)

    def sqout(self, semiring=PLUS_TIMES,
              reduce: Optional[int] = None) -> "LazyExpr":
        """AAᵀ as a graph; ``reduce=0/1`` for the fused vector."""
        sq = MatMul(self, Transpose(self), semiring=semiring)
        return sq if reduce is None else Reduce(sq, reduce, semiring=semiring)

    # -- evaluation ---------------------------------------------------------
    def collect(self):
        """Optimize and execute the graph; returns the layer-native result
        (array for structural nodes, dense vector/scalar for reductions)."""
        from .plan import execute
        return execute(self)

    # -- structural identity (hash-consing key) -----------------------------
    def key(self) -> tuple:
        raise NotImplementedError


class Source(LazyExpr):
    """A leaf: one concrete ``Assoc`` / ``AssocTensor``."""

    def __init__(self, array: Any):
        self.array = array

    def key(self) -> tuple:
        return ("src", id(self.array))

    def __repr__(self) -> str:
        return f"Source({type(self.array).__name__})"


class Select(LazyExpr):
    """Deferred D4M selection ``child[row_sel, col_sel]`` (any selector
    form the eager ``__getitem__`` takes)."""

    def __init__(self, child: LazyExpr, row_sel, col_sel):
        self.child = child
        self.row_sel = row_sel
        self.col_sel = col_sel

    def key(self) -> tuple:
        return ("select", self.child.key(),
                _sel_key(self.row_sel), _sel_key(self.col_sel))

    def __repr__(self) -> str:
        return f"Select({self.child!r}, {self.row_sel!r}, {self.col_sel!r})"


class _Binary(LazyExpr):
    tag = "?"

    def __init__(self, a: LazyExpr, b: LazyExpr, semiring=PLUS_TIMES):
        self.a = lazy(a)
        self.b = lazy(b)
        self.semiring = get_semiring(semiring)

    def key(self) -> tuple:
        return (self.tag, self.a.key(), self.b.key(), self.semiring.name)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.a!r}, {self.b!r}, "
                f"semiring={self.semiring.name})")


class EwiseAdd(_Binary):
    """Element-wise ⊕ over the union of key sets (paper §II.C.1)."""
    tag = "ewise_add"


class EwiseMul(_Binary):
    """Element-wise ⊗ over the intersection of key sets (paper §II.C.2)."""
    tag = "ewise_mul"


class MatMul(_Binary):
    """Array multiplication ``⊗.⊕`` contracting over col/row keys."""
    tag = "matmul"


class Reduce(LazyExpr):
    """⊕-reduction along an axis (``None`` → full scalar reduction).

    The result vector is indexed by the child result's row (``axis=1``)
    or col (``axis=0``) keyspace.  On device/dist that keyspace is always
    the source's full keyspace (selection never shrinks it); on host, a
    *fused* select+matmul reduce is likewise indexed by the unsliced
    ``a.row``/``b.col`` (deselected keys hold the ⊕-identity), whereas an
    eagerly materialized child would have condensed its keys first — zip
    the vector with the source keyspace, not the slice.
    """

    def __init__(self, child: LazyExpr, axis: Optional[int],
                 semiring=PLUS_TIMES):
        if axis not in (None, 0, 1):
            raise ValueError(f"axis must be None, 0 or 1, got {axis!r}")
        self.child = lazy(child)
        self.axis = axis
        self.semiring = get_semiring(semiring)

    def key(self) -> tuple:
        return ("reduce", self.child.key(), self.axis, self.semiring.name)

    def __repr__(self) -> str:
        return (f"Reduce({self.child!r}, axis={self.axis}, "
                f"semiring={self.semiring.name})")


class Transpose(LazyExpr):
    """Deferred transpose; the planner pushes selections through it."""

    def __init__(self, child: LazyExpr):
        self.child = lazy(child)

    def key(self) -> tuple:
        return ("transpose", self.child.key())

    def __repr__(self) -> str:
        return f"Transpose({self.child!r})"
