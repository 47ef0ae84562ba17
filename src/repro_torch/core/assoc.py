"""Paper-faithful host implementation of D4M associative arrays.

This module reproduces §II of the paper exactly: an associative array ``A``
is stored via four attributes,

* ``A.row`` — sorted unique row keys with nonempty entries (1-D numpy array),
* ``A.col`` — sorted unique column keys (1-D numpy array),
* ``A.val`` — the float ``1.0`` (numeric case) **or** the sorted unique
  nonempty values (string case),
* ``A.adj`` — a ``scipy.sparse`` matrix of shape ``(len(row), len(col))``;
  in the string case entries are **1-based** pointers into ``A.val``
  (``A[A.row[i], A.col[j]] == A.val[k]  ⟺  A.adj[i, j] == k + 1``).

Algebra follows the paper's approach: element-wise addition re-indexes both
operands onto the *sorted union* of key sets and defers to
``scipy.sparse`` addition; element-wise multiplication restricts to the
*sorted intersection*; array multiplication contracts over
``A.col ∩ B.row`` with native CSR matmul; ``condense()`` drops empty
rows/cols via CSR/CSC ``indptr`` diffs; ``logical()`` replaces nonempty
entries with 1.

All triple canonicalization (constructor aggregation, ``combine``,
assignment) routes through the shared canonical COO core in
``repro_torch.core.coo`` — the same primitive the device ``AssocTensor`` uses —
and the algebra is semiring-generic: :meth:`Assoc.add`, :meth:`Assoc.mul`
and :meth:`Assoc.matmul` accept any registered
:class:`~repro_torch.core.semiring.Semiring` (default ``(+,×)``), so graph idioms
like ``sqin`` run under ``min_plus``/``max_min`` on host exactly as on
device.

This host class is the **reproduction baseline** benchmarked against the
paper's Figs 3–7; the device ``AssocTensor`` lives in
``assoc_tensor.py``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

from .coo import (apply_pair, canonicalize_np, intersect_pairs_np,
                  linearize_pairs_np)
from .expr import EwiseAdd, EwiseMul, MatMul, Select, Source
from .keyspace import KeySpace
from .select import (Selector, compile_selector, sanitize_keys,
                     split_string_list)
from .semiring import PLUS_TIMES, get_semiring
from .sorted_ops import sorted_intersect, sorted_union

__all__ = ["Assoc", "is_string_array"]

KeyLike = Union[str, float, int, Sequence, np.ndarray, slice, Selector]


def _is_str_kind(arr: np.ndarray) -> bool:
    return arr.dtype.kind in ("U", "S", "O")


def is_string_array(arr: np.ndarray) -> bool:
    return _is_str_kind(np.asarray(arr))


# the key-coercion rule is shared with selector parsing (select.Keys)
_sanitize_keys = sanitize_keys


def _broadcast(row, col, val):
    """Broadcast row/col/val to a common length (paper constructor rule)."""
    n = max(len(row), len(col), len(val))
    out = []
    for a in (row, col, val):
        if len(a) == n:
            out.append(a)
        elif len(a) == 1:
            out.append(np.broadcast_to(a, (n,)).copy())
        else:
            raise ValueError(
                f"cannot broadcast lengths {(len(row), len(col), len(val))}")
    return out


class Assoc:
    """D4M associative array (paper-faithful host implementation)."""

    __array_priority__ = 100  # win against numpy binary ops

    # ------------------------------------------------------------------ #
    # construction                                                       #
    # ------------------------------------------------------------------ #
    def __init__(self, row=(), col=(), val=(), aggregate=min, adj=None):
        if adj is not None:
            self._init_from_adj(row, col, val, adj)
            return
        row = _sanitize_keys(row)
        col = _sanitize_keys(col)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            val = np.full(1, float(val))
        val = _sanitize_keys(val) if not isinstance(val, np.ndarray) else val
        if val.ndim == 0:
            val = val.reshape(1)
        if len(row) == 0 or len(col) == 0 or len(val) == 0:
            self._init_empty()
            return
        row, col, val = _broadcast(row, col, val)

        numeric = not _is_str_kind(val)
        if numeric:
            val = val.astype(np.float64)
            keep = val != 0.0
        else:
            val = val.astype(str)
            keep = val != ""
        row, col, val = row[keep], col[keep], val[keep]
        if len(row) == 0:
            self._init_empty()
            return

        # unique key spaces + integer codes
        self.row, row_codes = np.unique(row, return_inverse=True)
        self.col, col_codes = np.unique(col, return_inverse=True)

        # canonical COO core: lexsort + duplicate-run ⊕-merge + compaction
        r, c, v = canonicalize_np(row_codes, col_codes, val, combine=aggregate)

        if numeric:
            self.val = 1.0
            data = v.astype(np.float64)
        else:
            self.val, v_codes = np.unique(v.astype(str), return_inverse=True)
            data = v_codes.astype(np.float64) + 1.0  # 1-based pointers
        self.adj = sp.coo_matrix(
            (data, (r, c)), shape=(len(self.row), len(self.col)))
        self._drop_zeros_and_condense()

    def _init_from_adj(self, row, col, val, adj):
        """Paper's second constructor: keys + explicit sparse matrix."""
        row = np.unique(_sanitize_keys(row))
        col = np.unique(_sanitize_keys(col))
        adj = sp.coo_matrix(adj)
        if adj.shape[0] > len(row) or adj.shape[1] > len(col):
            raise ValueError("adj larger than provided key sets")
        self.row = row[: adj.shape[0]]
        self.col = col[: adj.shape[1]]
        if isinstance(val, float):
            self.val = 1.0
        else:
            self.val = np.unique(_sanitize_keys(val))
        self.adj = adj
        self._drop_zeros_and_condense()

    def _init_empty(self):
        self.row = np.empty(0, dtype=np.float64)
        self.col = np.empty(0, dtype=np.float64)
        self.val = 1.0
        self.adj = sp.coo_matrix((0, 0))

    @classmethod
    def _from_parts(cls, row, col, val, adj) -> "Assoc":
        a = cls.__new__(cls)
        a.row = np.asarray(row)
        a.col = np.asarray(col)
        a.val = val
        a.adj = adj if sp.issparse(adj) else sp.coo_matrix(adj)
        return a

    @classmethod
    def _assemble(cls, row_keys, col_keys, r, c, v) -> "Assoc":
        """Build from canonical code triples over given key arrays.

        Values are stored exactly — an explicit ``0.0`` that is *not* the
        ambient semiring's zero survives — and empty rows/cols are condensed
        away.  This is the assembly step of the semiring-generic algebra.
        """
        adj = sp.coo_matrix((np.asarray(v, dtype=np.float64), (r, c)),
                            shape=(len(row_keys), len(col_keys)))
        out = cls._from_parts(np.asarray(row_keys), np.asarray(col_keys),
                              1.0, adj)
        out.condense()
        return out

    # ------------------------------------------------------------------ #
    # basic properties                                                   #
    # ------------------------------------------------------------------ #
    @property
    def numeric(self) -> bool:
        return isinstance(self.val, float)

    def nnz(self) -> int:
        return int(self.adj.nnz)

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.row), len(self.col))

    def triples(self):
        """Return (row_keys, col_keys, values) of the nonempty entries."""
        coo = self.adj.tocoo()
        rows = self.row[coo.row] if len(self.row) else self.row
        cols = self.col[coo.col] if len(self.col) else self.col
        if self.numeric:
            vals = coo.data.copy()
        else:
            vals = self.val[(coo.data - 1).astype(np.int64)]
        return rows, cols, vals

    def to_dict(self) -> dict:
        r, c, v = self.triples()
        return {(ri, ci): vi for ri, ci, vi in zip(r.tolist(), c.tolist(), v.tolist())}

    def get(self, i, j, default=None):
        d = self.to_dict()
        return d.get((i, j), default)

    # ------------------------------------------------------------------ #
    # cleanup: paper's condense() + explicit-zero elimination            #
    # ------------------------------------------------------------------ #
    def _drop_zeros_and_condense(self):
        adj = self.adj.tocoo()
        if adj.nnz:
            keep = adj.data != 0.0
            if not keep.all():
                adj = sp.coo_matrix(
                    (adj.data[keep], (adj.row[keep], adj.col[keep])),
                    shape=adj.shape)
        self.adj = adj
        self.condense()

    def condense(self) -> "Assoc":
        """Remove empty rows/cols (paper's .condense(), CSR/CSC indptr diff)."""
        csr = self.adj.tocsr()
        csc = self.adj.tocsc()
        csr_rows = csr.indptr
        csc_cols = csc.indptr
        good_rows = csr_rows[:-1] < csr_rows[1:]
        good_cols = csc_cols[:-1] < csc_cols[1:]
        if good_rows.all() and good_cols.all():
            self.adj = csr.tocoo()
            self._remap_vals()
            return self
        self.row = self.row[good_rows]
        self.col = self.col[good_cols]
        self.adj = csr[good_rows, :][:, good_cols].tocoo()
        self._remap_vals()
        return self

    def _remap_vals(self):
        """Shrink .val to the values actually referenced (string case)."""
        if self.numeric or self.adj.nnz == 0:
            if not self.numeric and self.adj.nnz == 0:
                self.val = 1.0  # empty arrays are stored as-if numeric
            return
        codes = (self.adj.data - 1).astype(np.int64)
        used = np.unique(codes)
        if len(used) == len(self.val):
            return
        remap = np.zeros(len(self.val), dtype=np.int64)
        remap[used] = np.arange(len(used))
        self.val = self.val[used]
        self.adj = sp.coo_matrix(
            (remap[codes] + 1.0, (self.adj.row, self.adj.col)),
            shape=self.adj.shape)

    def logical(self) -> "Assoc":
        """Replace every nonempty entry with 1 (paper's .logical())."""
        adj = self.adj.tocoo(copy=True)
        adj.data = np.ones(len(adj.data))
        return Assoc._from_parts(self.row.copy(), self.col.copy(), 1.0, adj)

    # ------------------------------------------------------------------ #
    # lazy expressions (the deferred pipeline API, repro_torch.core.expr)      #
    # ------------------------------------------------------------------ #
    def lazy(self) -> Source:
        """Wrap this array as a lazy expression Source: operators then
        build a graph instead of executing, and ``.collect()`` runs the
        planned pipeline (selector pushdown, matmul→reduce fusion, …)."""
        return Source(self)

    # ------------------------------------------------------------------ #
    # element-wise addition (paper §II.C.1)                              #
    # ------------------------------------------------------------------ #
    def __add__(self, other: "Assoc") -> "Assoc":
        # thin wrapper: build a one-node graph and collect it (the lazy
        # and eager APIs share one execution path; Node operands defer to
        # the expression's reflected operator instead)
        if not isinstance(other, Assoc):
            return NotImplemented
        return EwiseAdd(Source(self), Source(other)).collect()

    def _add_eager(self, other: "Assoc") -> "Assoc":
        """Physical ⊕ under ``(+,×)`` (the executor's host backend)."""
        if self.nnz() == 0:
            return other.copy()
        if other.nnz() == 0:
            return self.copy()
        if self.numeric and other.numeric:
            return self._add_numeric(other)
        if not self.numeric and not other.numeric:
            return self.combine(other, "concat")
        raise TypeError("mixed numeric/string element-wise addition")

    def add(self, other: "Assoc", semiring=PLUS_TIMES) -> "Assoc":
        """Element-wise ⊕ over the union of key sets, semiring-generic.

        With the default ``(+,×)`` this is exactly ``self + other`` (scipy
        fast path, string concatenation).  Any other registered semiring
        runs through the canonical COO core: rank both operands into union
        keyspaces, concatenate triples, ⊕-merge duplicate pairs.
        """
        sr = get_semiring(semiring)
        if not isinstance(other, Assoc):
            raise TypeError("Assoc.add expects an Assoc")
        if sr.name == "plus_times":
            return self._add_eager(other)
        if not (self.numeric and other.numeric):
            raise TypeError("semiring algebra requires numeric arrays")
        if self.nnz() == 0:
            return other.copy()
        if other.nnz() == 0:
            return self.copy()
        rec = self._union_recode(other)
        if rec is None:
            raise TypeError("cannot mix string and numeric key sets")
        row_u, col_u, (ar, ac, acoo), (br, bc, bcoo) = rec
        r, c, v = canonicalize_np(
            np.concatenate([ar, br]), np.concatenate([ac, bc]),
            np.concatenate([acoo.data, bcoo.data]), combine=sr.add_np)
        keep = v != sr.zero
        return Assoc._assemble(row_u, col_u, r[keep], c[keep], v[keep])

    def _add_numeric(self, other: "Assoc") -> "Assoc":
        row_union, ia, ib = sorted_union(self.row, other.row)
        col_union, ja, jb = sorted_union(self.col, other.col)
        a = self._reindexed(ia, ja, (len(row_union), len(col_union)))
        b = other._reindexed(ib, jb, (len(row_union), len(col_union)))
        c_adj_pre = a.tocsr() + b.tocsr()
        out = Assoc._from_parts(row_union, col_union, 1.0, c_adj_pre.tocoo())
        out._drop_zeros_and_condense()
        return out

    def _reindexed(self, imap, jmap, shape) -> sp.coo_matrix:
        coo = self.adj.tocoo()
        return sp.coo_matrix(
            (coo.data, (imap[coo.row], jmap[coo.col])), shape=shape)

    def combine(self, other: "Assoc", binop) -> "Assoc":
        """Triple-append + one canonicalize pass (paper's ``Assoc.combine``).

        ``binop`` is an aggregator understood by the canonical COO core:
        a name (``"min"``/``"max"``/``"sum"``/``"concat"``/``"first"``/
        ``"last"``), a numpy ufunc, or a python callable (slow path).  Both
        operands are re-ranked onto union key spaces (their codes are
        already ranks — no key re-sorting), triples concatenated (self
        first, so order-sensitive ⊕ like concatenation sees self's value on
        the left) and merged in a single vectorized canonicalization — no
        per-element loops.
        """
        if self.nnz() and other.nnz() and self.numeric != other.numeric:
            raise TypeError("combine requires same value kind")
        if self.nnz() == 0:
            return other.copy()
        if other.nnz() == 0:
            return self.copy()
        rec = self._union_recode(other)
        if rec is None:
            raise TypeError("cannot mix string and numeric key sets")
        row_u, col_u, (ar, ac, acoo), (br, bc, bcoo) = rec
        # both operands are canonical ⇒ duplicate runs have length exactly 2
        # and are the support intersection: fold ONLY those pairs, pass the
        # disjoint remainder through untouched.
        ia, ib = intersect_pairs_np(linearize_pairs_np(ar, ac, len(col_u)),
                                    linearize_pairs_np(br, bc, len(col_u)))
        only_a = np.ones(len(ar), dtype=bool)
        only_a[ia] = False
        only_b = np.ones(len(br), dtype=bool)
        only_b[ib] = False

        if self.numeric:
            merged = apply_pair(binop, acoo.data[ia], bcoo.data[ib])
            # drop zeros only among NEWLY merged values: an explicit 0.0
            # already stored by an operand (legit under non-(+,×)
            # semirings) passes through untouched per _assemble's contract
            mkeep = merged != 0.0
            rows = np.concatenate([ar[only_a], br[only_b], ar[ia][mkeep]])
            cols = np.concatenate([ac[only_a], bc[only_b], ac[ia][mkeep]])
            vals = np.concatenate([acoo.data[only_a], bcoo.data[only_b],
                                   merged[mkeep]])
            return Assoc._assemble(row_u, col_u, rows, cols, vals)

        # string case: stay in rank space — non-overlapping entries keep
        # their pointer into the merged value dictionary; only the folded
        # pair values are materialized as strings.
        val_u, vam, vbm = sorted_union(self.val, other.val)
        merged = apply_pair(binop, self.val[(acoo.data[ia] - 1).astype(np.int64)],
                            other.val[(bcoo.data[ib] - 1).astype(np.int64)])
        merged = np.asarray(merged, dtype=str)
        mkeep = merged != ""  # empty string ⇒ unstored (paper rule)
        merged = merged[mkeep]
        # grow the value dictionary with genuinely new folded strings —
        # a small sorted insert, never a re-sort of the full value set
        mu = np.unique(merged)
        pos = np.searchsorted(val_u, mu)
        pos_c = np.clip(pos, 0, max(len(val_u) - 1, 0))
        new_vals = mu[val_u[pos_c] != mu] if len(val_u) else mu
        # concatenate (promotes the string width) + stable timsort merge of
        # the two sorted runs; disjoint by construction ⇒ sorted unique
        val_all = np.concatenate([val_u, new_vals])
        val_all.sort(kind="stable")
        shift = np.searchsorted(new_vals, val_u)  # old rank → new rank offset
        a_ranks = vam[(acoo.data - 1).astype(np.int64)]
        b_ranks = vbm[(bcoo.data - 1).astype(np.int64)]
        a_ranks = a_ranks + shift[a_ranks]
        b_ranks = b_ranks + shift[b_ranks]
        m_ranks = np.searchsorted(val_all, merged)
        rows = np.concatenate([ar[only_a], br[only_b], ar[ia][mkeep]])
        cols = np.concatenate([ac[only_a], bc[only_b], ac[ia][mkeep]])
        data = np.concatenate([a_ranks[only_a], b_ranks[only_b],
                               m_ranks]).astype(np.float64) + 1.0
        adj = sp.coo_matrix((data, (rows, cols)),
                            shape=(len(row_u), len(col_u)))
        out = Assoc._from_parts(row_u, col_u, val_all, adj)
        out.condense()
        return out

    def min(self, other: "Assoc") -> "Assoc":
        return self.combine(other, "min")

    def max(self, other: "Assoc") -> "Assoc":
        return self.combine(other, "max")

    def __sub__(self, other: "Assoc") -> "Assoc":
        if not (self.numeric and other.numeric):
            raise TypeError("subtraction requires numeric associative arrays")
        neg = other.copy()
        adj = neg.adj.tocoo(copy=True)
        adj.data = -adj.data
        neg.adj = adj
        return self + neg

    # ------------------------------------------------------------------ #
    # element-wise multiplication (paper §II.C.2)                        #
    # ------------------------------------------------------------------ #
    def __mul__(self, other: "Assoc") -> "Assoc":
        # thin wrapper over the one-node graph (see __add__)
        if not isinstance(other, Assoc):
            return NotImplemented
        return EwiseMul(Source(self), Source(other)).collect()

    def _mul_eager(self, other: "Assoc") -> "Assoc":
        """Physical ⊗ under ``(+,×)`` (the executor's host backend)."""
        if self.numeric and other.numeric:
            return self._mul_numeric(other)
        if not self.numeric and other.numeric:
            # numeric acts as a mask on the string array (paper)
            return self._mask_by(other)
        if self.numeric and not other.numeric:
            # reduced to the numeric case via .logical() (paper)
            return self._mul_numeric(other.logical())
        # string * string: intersection with ⊗ = min (default aggregator)
        return self._mul_string(other)

    def mul(self, other: "Assoc", semiring=PLUS_TIMES) -> "Assoc":
        """Element-wise ⊗ over the intersection of key sets, semiring-generic.

        Default ``(+,×)`` is exactly ``self * other``.  Other semirings run
        as a rank-based sorted intersection of (row, col) pair codes with ⊗
        applied across each matched pair.
        """
        sr = get_semiring(semiring)
        if not isinstance(other, Assoc):
            raise TypeError("Assoc.mul expects an Assoc")
        if sr.name == "plus_times":
            return self._mul_eager(other)
        if not (self.numeric and other.numeric):
            raise TypeError("semiring algebra requires numeric arrays")
        if self.nnz() == 0 or other.nnz() == 0:
            return Assoc()
        rec = self._union_recode(other)
        if rec is None:
            return Assoc()
        row_u, col_u, (ar, ac, acoo), (br, bc, bcoo) = rec
        ia, ib = intersect_pairs_np(linearize_pairs_np(ar, ac, len(col_u)),
                                    linearize_pairs_np(br, bc, len(col_u)))
        if len(ia) == 0:
            return Assoc()
        v = sr.mul_np(acoo.data[ia], bcoo.data[ib])
        keep = v != sr.zero
        return Assoc._assemble(row_u, col_u, ar[ia][keep], ac[ia][keep],
                               v[keep])

    def _mul_numeric(self, other: "Assoc") -> "Assoc":
        row_int, ia, ib = sorted_intersect(self.row, other.row)
        col_int, ja, jb = sorted_intersect(self.col, other.col)
        if len(row_int) == 0 or len(col_int) == 0:
            return Assoc()
        a = self.adj.tocsr()[ia, :][:, ja]
        b = other.adj.tocsr()[ib, :][:, jb]
        out = Assoc._from_parts(row_int, col_int, 1.0, a.multiply(b).tocoo())
        out._drop_zeros_and_condense()
        return out

    def _union_recode(self, other: "Assoc"):
        """Re-rank both operands' COO codes onto union key spaces.

        Both arrays are canonical, so ``adj`` codes are already ranks into
        their sorted key arrays; one ``sorted_union`` per axis plus a gather
        re-ranks every triple without touching the (possibly string) keys
        again.  Returns ``(row_u, col_u, (ar, ac, acoo), (br, bc, bcoo))``
        or None when the key kinds cannot intersect.
        """
        if (_is_str_kind(self.row) != _is_str_kind(other.row)
                or _is_str_kind(self.col) != _is_str_kind(other.col)):
            return None
        row_u, ram, rbm = sorted_union(self.row, other.row)
        col_u, cam, cbm = sorted_union(self.col, other.col)
        acoo = self.adj.tocoo()
        bcoo = other.adj.tocoo()
        return (row_u, col_u,
                (ram[acoo.row], cam[acoo.col], acoo),
                (rbm[bcoo.row], cbm[bcoo.col], bcoo))

    def _pair_intersect(self, other: "Assoc"):
        """Rank-based sorted intersection of both arrays' (row, col) sets.

        Returns ``(ia, ib)`` positions into the two COO entry lists (or
        None when empty/kind-mismatched) — the vectorized replacement for
        per-element dictionary probing in mask/string multiplication.
        """
        if self.nnz() == 0 or other.nnz() == 0:
            return None
        rec = self._union_recode(other)
        if rec is None:
            return None
        _, col_u, (ar, ac, _), (br, bc, _) = rec
        return intersect_pairs_np(linearize_pairs_np(ar, ac, len(col_u)),
                                  linearize_pairs_np(br, bc, len(col_u)))

    def _mask_by(self, mask: "Assoc") -> "Assoc":
        """Restrict a string array to the support of a numeric mask."""
        hit = self._pair_intersect(mask)
        if hit is None:
            return Assoc()
        ia, _ = hit
        # the result is a sub-array of self: same key/value spaces, subset
        # of adj entries — no re-canonicalization needed
        coo = self.adj.tocoo()
        sub = sp.coo_matrix((coo.data[ia], (coo.row[ia], coo.col[ia])),
                            shape=self.adj.shape)
        out = Assoc._from_parts(
            self.row.copy(), self.col.copy(),
            self.val if self.numeric else self.val.copy(), sub)
        out.condense()
        return out

    def _mul_string(self, other: "Assoc") -> "Assoc":
        """String ⊗ string: pair intersection with ⊗ = min (dict order)."""
        hit = self._pair_intersect(other)
        if hit is None:
            return Assoc()
        ia, ib = hit
        coo_a = self.adj.tocoo()
        coo_b = other.adj.tocoo()
        # decode values only for the matched pairs (the intersection is
        # typically far smaller than either operand), ⊗ = dictionary min
        va = self.val[(coo_a.data[ia] - 1).astype(np.int64)]
        vb = other.val[(coo_b.data[ib] - 1).astype(np.int64)]
        return Assoc(self.row[coo_a.row[ia]], self.col[coo_a.col[ia]],
                     np.where(va <= vb, va, vb))

    # ------------------------------------------------------------------ #
    # array multiplication (paper §II.C.3)                               #
    # ------------------------------------------------------------------ #
    def __matmul__(self, other: "Assoc") -> "Assoc":
        # thin wrapper over the one-node graph (see __add__)
        if not isinstance(other, Assoc):
            return NotImplemented
        return MatMul(Source(self), Source(other)).collect()

    def _matmul_eager(self, other: "Assoc") -> "Assoc":
        """Physical ``⊗.⊕`` under ``(+,×)``: native CSR matmul."""
        a = self.logical() if not self.numeric else self
        b = other.logical() if not other.numeric else other
        inner, ia, ib = sorted_intersect(a.col, b.row)
        if len(inner) == 0:
            return Assoc()
        a_m = a.adj.tocsr()[:, ia]
        b_m = b.adj.tocsr()[ib, :]
        prod = (a_m @ b_m).tocoo()
        out = Assoc._from_parts(a.row, b.col, 1.0, prod)
        out._drop_zeros_and_condense()
        return out

    def matmul(self, other: "Assoc", semiring=PLUS_TIMES) -> "Assoc":
        """Array multiplication ``⊗.⊕`` contracting over ``A.col ∩ B.row``.

        Default ``(+,×)`` is exactly ``self @ other`` (native CSR matmul).
        Other semirings contract through the canonical COO core's
        vectorized sort-merge join (``spgemm_np``) with ⊗ on matched pairs
        and a single ⊕-canonicalize of the expanded products.
        """
        sr = get_semiring(semiring)
        if not isinstance(other, Assoc):
            raise TypeError("Assoc.matmul expects an Assoc")
        if sr.name == "plus_times":
            return self._matmul_eager(other)
        # the one host sort-merge join (shared with the planner's fused
        # select+matmul — this is the keeps=None case)
        from .plan import host_matmul
        return host_matmul(self, None, other, None, sr, None)

    def matmul_reduce(self, other: "Assoc", axis: int = 1,
                      semiring=PLUS_TIMES) -> np.ndarray:
        """Fused ``⊕-reduce(self ⊗.⊕ other, axis)`` — C never materializes.

        The host half of the Graphulo pushdown: since ⊕ is associative and
        commutative, ``⊕_j C[i,j]`` folds directly over the expanded
        semiring products — one CSR-style segment scatter
        (:func:`repro_torch.core.coo.spgemm_reduce_np`) instead of the full
        canonicalize that builds C's triples.  ``(+,×)`` collapses further
        to two sparse matvecs (``A @ (B @ 1)``).  Returns a dense vector
        aligned with ``self.row`` (``axis=1``) or ``other.col``
        (``axis=0``).
        """
        sr = get_semiring(semiring)
        if not isinstance(other, Assoc):
            raise TypeError("Assoc.matmul_reduce expects an Assoc")
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0 or 1, got {axis!r}")
        # the one host sort-merge join + segment scatter (shared with the
        # planner's fused select+matmul_reduce — the keeps=None case)
        from .plan import host_matmul
        return host_matmul(self, None, other, None, sr, axis)

    def sqin(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AᵀA — the paper's correlation idiom (column-key graph).

        ``reduce=0/1`` returns the fused ⊕-reduction of the square
        (a dense vector over ``self.col``) instead of the square itself.
        """
        t = self.transpose()
        if reduce is None:
            return t.matmul(self, semiring)
        return t.matmul_reduce(self, reduce, semiring)

    def sqout(self, semiring=PLUS_TIMES, reduce: Optional[int] = None):
        """AAᵀ — row-key graph; ``reduce=0/1`` for the fused reduction
        (a dense vector over ``self.row``)."""
        t = self.transpose()
        if reduce is None:
            return self.matmul(t, semiring)
        return self.matmul_reduce(t, reduce, semiring)

    # ------------------------------------------------------------------ #
    # structural ops                                                     #
    # ------------------------------------------------------------------ #
    def transpose(self) -> "Assoc":
        return Assoc._from_parts(
            self.col.copy(), self.row.copy(),
            self.val if self.numeric else self.val.copy(),
            self.adj.transpose().tocoo())

    @property
    def T(self) -> "Assoc":
        return self.transpose()

    def copy(self) -> "Assoc":
        return Assoc._from_parts(
            self.row.copy(), self.col.copy(),
            self.val if self.numeric else self.val.copy(),
            self.adj.copy())

    def to_tensor(self, *, capacity: Optional[int] = None,
                  row_space=None, col_space=None, device="cuda"):
        """Upload to the device :class:`~repro_torch.core.assoc_tensor.AssocTensor`.

        Inverse of ``AssocTensor.to_assoc()``: the round trip is lossless
        for string values (rank pointer scheme) and for numeric values
        representable in float32 — EXCEPT explicit ``0.0`` entries (as
        produced by non-(+,×) semiring algebra, e.g. a zero-cost
        ``min_plus`` path), which the device's 0-is-empty storage drops.
        Pass explicit keyspaces to align the result with other device
        arrays without a re-rank.  ``device`` defaults to ``"cuda"``;
        pass ``"cpu"`` to build on the host.
        """
        from .assoc_tensor import AssocTensor
        return AssocTensor.from_assoc(self, capacity,
                                      row_space=row_space,
                                      col_space=col_space, device=device)

    def sum(self, axis: Optional[int] = None, semiring=PLUS_TIMES):
        """⊕-reduce (default sum) via the shared reduce path in
        :mod:`repro_torch.core.plan` — one host implementation for the Reduce
        node, ``AssocTensor`` and this wrapper, so reduction dtype/zero
        rules live in one place.  Note the Assoc wrapper drops entries
        equal to 0.0 (the paper's unstored value); non-(+,×) reductions
        whose ⊕-identity is not 0 are better consumed through the lazy
        ``.sum()`` vector form."""
        from .plan import host_axis_reduce
        if axis is None:
            return host_axis_reduce(self, None, semiring)
        m = host_axis_reduce(self, axis, semiring)
        if axis == 0:   # column sums → row vector keyed by col
            return Assoc(["sum"], self.col, m)
        return Assoc(self.row, ["sum"], m)  # row sums → column vector

    # ------------------------------------------------------------------ #
    # extraction & assignment (paper §II.B) — via the selector algebra   #
    # ------------------------------------------------------------------ #
    def _axis_space(self, keys: np.ndarray) -> KeySpace:
        """Lazy per-axis KeySpace (row/col arrays are already sorted-unique).

        Cached by array identity: mutation replaces ``self.row``/``self.col``
        wholesale, so an ``is`` check detects staleness.  The KeySpace
        content hash is what makes selector compilation cacheable across
        repeated queries on the same key dictionary.
        """
        cache = getattr(self, "_space_cache", None)
        if cache is None:
            cache = self._space_cache = {}
        slot = "row" if keys is self.row else "col"
        hit = cache.get(slot)
        if hit is not None and hit.keys is keys:
            return hit
        ks = KeySpace.from_sorted_unique(keys)
        cache[slot] = ks
        return ks

    def _resolve_keys(self, sel, keys: np.ndarray) -> np.ndarray:
        """Resolve any selector to sorted integer positions into ``keys``.

        Accepts every D4M index form — explicit lists, positional
        slices/ints, ``'a,:,b,'`` ranges — plus first-class
        :class:`~repro_torch.core.select.Selector` objects
        (``StartsWith``/``Match``/``Where``/``Mask`` and ``&``/``|``/``~``
        compositions), all through one cached compilation path.
        """
        return compile_selector(sel, self._axis_space(keys)).positions()

    def __getitem__(self, ij) -> "Assoc":
        # thin wrapper over the one-node graph (see __add__)
        i, j = ij
        return Select(Source(self), i, j).collect()

    def _select_eager(self, ij) -> "Assoc":
        """Physical selection (the executor's host backend)."""
        i, j = ij
        ri = self._resolve_keys(i, self.row)
        ci = self._resolve_keys(j, self.col)
        if len(ri) == 0 or len(ci) == 0:
            return Assoc()
        sub = self.adj.tocsr()[ri, :][:, ci].tocoo()
        out = Assoc._from_parts(
            self.row[ri], self.col[ci],
            self.val if self.numeric else self.val.copy(), sub)
        out.condense()
        return out

    @staticmethod
    def _is_selector_arg(sel) -> bool:
        """Index forms that *select existing keys* (vs. name new ones).

        Must agree with ``__getitem__``'s reading of the same argument:
        2-tuples are inclusive ranges and bool arrays are masks on both
        sides, so get/set never diverge.  Plain key lists (including
        ``'a,b,'`` strings and numeric arrays) stay on the legacy
        assignment path, which may introduce new keys.
        """
        if isinstance(sel, (Selector, slice)):
            return True
        if isinstance(sel, tuple) and len(sel) == 2:
            return True
        if isinstance(sel, str):
            parts = split_string_list(sel)
            return sel == ":" or (len(parts) == 3 and parts[1] == ":")
        arr = np.asarray(sel)
        return arr.ndim > 0 and arr.dtype.kind == "b"  # mask (list or array)

    def _commit(self, merged: "Assoc") -> None:
        """Adopt another Assoc's state (the single assignment commit step)."""
        self.row, self.col = merged.row, merged.col
        self.val, self.adj = merged.val, merged.adj

    def __setitem__(self, ij, value):
        i, j = ij
        if isinstance(value, Assoc):
            # "last" wins: one canonicalize pass with the assigned triples
            # appended after self's (stable sort keeps them last in each run)
            self._commit(self.combine(value, "last") if self.nnz()
                         else value.copy())
            return
        if self._is_selector_arg(i) or self._is_selector_arg(j):
            # selector-targeted fill: resolve each axis against the existing
            # keys and assign the scalar over the selection's cross product
            rk = (self.row[self._resolve_keys(i, self.row)]
                  if self._is_selector_arg(i) else _sanitize_keys(i))
            ck = (self.col[self._resolve_keys(j, self.col)]
                  if self._is_selector_arg(j) else _sanitize_keys(j))
            if len(rk) == 0 or len(ck) == 0:
                return
            rr, cc = np.meshgrid(rk, ck, indexing="ij")
            patch = Assoc(rr.ravel(), cc.ravel(), np.full(rr.size, value))
            self._commit(self.combine(patch, "last") if self.nnz()
                         else patch.copy())
            return
        r, c, v = self.triples()
        rows = np.concatenate([r.astype(str) if _is_str_kind(r) else r,
                               _sanitize_keys(i)]) if len(r) else _sanitize_keys(i)
        cols = np.concatenate([c.astype(str) if _is_str_kind(c) else c,
                               _sanitize_keys(j)]) if len(c) else _sanitize_keys(j)
        vals = np.concatenate([v, np.asarray([value])]) if len(r) else np.asarray([value])
        self._commit(Assoc(rows, cols, vals, aggregate="last"))

    # ------------------------------------------------------------------ #
    # comparison / display                                               #
    # ------------------------------------------------------------------ #
    def __eq__(self, other) -> bool:  # structural equality of nonempty maps
        if not isinstance(other, Assoc):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):  # pragma: no cover - dict-keyed usage is unusual
        return id(self)

    def __repr__(self) -> str:
        r, c, v = self.triples()
        lines = [f"Assoc({len(self.row)}x{len(self.col)}, nnz={self.nnz()})"]
        for t, (ri, ci, vi) in enumerate(zip(r, c, v)):
            if t >= 8:
                lines.append(f"  ... ({self.nnz() - 8} more)")
                break
            lines.append(f"  ({ri!r}, {ci!r}) : {vi!r}")
        return "\n".join(lines)

    @staticmethod
    def _labels(arr) -> list:
        """Render keys/values for display: MATLAB ``num2str`` semantics for
        numerics (``1`` not ``1.0``), plain ``str`` for strings."""
        if is_string_array(arr):
            return [str(x) for x in arr.tolist()]
        return ["%.11g" % x for x in arr.tolist()]

    def printfull(self) -> str:
        """Tabular rendering like the paper's Fig. 1.

        Per-column widths come from a single scatter-max pass over the
        nonempty triples (linear in nnz + columns, robust to single-row and
        empty arrays).  Numeric arrays render exactly like string arrays —
        left-justified cells, MATLAB ``num2str`` number formatting — so the
        output matches the MATLAB D4M rendering for both value kinds.
        """
        rows = self._labels(self.row)
        cols = self._labels(self.col)
        coo = self.adj.tocoo()
        _, _, vals = self.triples()
        cells = np.asarray(self._labels(vals), dtype=object)
        widths = np.asarray([len(c) for c in cols], dtype=np.int64)
        if len(cells) and len(widths):
            np.maximum.at(widths, coo.col,
                          np.asarray([len(s) for s in cells], dtype=np.int64))
        grid = np.full((len(rows), len(cols)), "", dtype=object)
        if len(cells):
            grid[coo.row, coo.col] = cells
        rw = max((len(r) for r in rows), default=0)
        out = [" " * rw + "  "
               + "  ".join(c.ljust(int(w)) for c, w in zip(cols, widths))]
        for i, rl in enumerate(rows):
            body = "  ".join(str(grid[i, j]).ljust(int(widths[j]))
                             for j in range(len(cols)))
            out.append(rl.ljust(rw) + "  " + body)
        s = "\n".join(out)
        print(s)
        return s
