"""D4M selector algebra: one query language for every associative array.

The defining surface of D4M is associative-array indexing — explicit key
lists ``A['alice,bob,', :]``, right-inclusive ranges ``'a,:,b,'``, prefix
queries ``StartsWith('ab,')`` — which the paper presents as the composable
query language that turns associative arrays into a database interface.
This module makes that language first-class and layer-independent:

* a small set of :class:`Selector` objects — :class:`Keys`, :class:`Range`,
  :class:`StartsWith`, :class:`Match`, :class:`Where`, :class:`Mask`,
  :class:`Positions`, :class:`All` — closed under ``&`` / ``|`` / ``~``;
* each selector **compiles against a** :class:`~repro_torch.core.keyspace.KeySpace`
  into a :class:`Compiled` form that is either a *contiguous rank range*
  ``[lo, hi)`` (the device fast path) or a *sorted index set* (the gather
  path); composition happens on compiled forms with the sorted-set
  primitives from :mod:`repro_torch.core.sorted_ops`;
* compilation is **cached per (KeySpace, selector)** — keyspaces are
  immutable and content-hashed, so repeated queries on the same key
  dictionary skip the searchsorted/regex work entirely.

``Assoc`` (host) and ``AssocTensor`` (device) both resolve their ``__getitem__`` selectors through :func:`compile_selector`,
so ``A[sel, :]`` means the same thing — and returns the same entries — on
every layer.
"""
from __future__ import annotations

import hashlib
import re
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from .keyspace import KeySpace
from .sorted_ops import sorted_intersect, sorted_union

__all__ = [
    "Selector", "Keys", "Range", "StartsWith", "Match", "Where", "Mask",
    "Positions", "All", "And", "Or", "Not", "Compiled",
    "as_selector", "compile_selector", "plan_boxes", "sanitize_keys",
    "split_string_list",
    "CACHE_STATS", "clear_compile_cache", "reset_cache_stats",
]

# D4M string-list convention: a string whose final character is a separator
# encodes a list, e.g. "a,b,c," == ["a","b","c"];  "a,:,b," is a range.
SEPARATORS = (",", ";", "\t", "|")


def split_string_list(s: str):
    """Split a D4M string-list (trailing separator chooses the delimiter)."""
    if len(s) > 0 and s[-1] in SEPARATORS:
        sep = s[-1]
        return [p for p in s.split(sep) if p != ""]
    return [s]


def sanitize_keys(keys) -> np.ndarray:
    """Coerce a key argument to a 1-D numpy array of str or float.

    The one key-coercion rule shared by selector parsing (:class:`Keys`)
    and ``Assoc`` construction/assignment.
    """
    if isinstance(keys, str):
        keys = split_string_list(keys)
    arr = np.asarray(keys)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.dtype.kind in ("U", "S", "O"):
        return arr.astype(str)
    return arr.astype(np.float64)


def _payload_digest(b: bytes) -> bytes:
    """Fixed-size stand-in for large byte payloads in cache keys: without
    it, Mask/Keys entries over big keyspaces pin their full payload in the
    cache key and every lookup re-hashes megabytes."""
    return hashlib.sha1(b).digest()


# ---------------------------------------------------------------------------
# Compiled form
# ---------------------------------------------------------------------------

class Compiled:
    """A selector compiled against one KeySpace.

    Either a contiguous half-open rank range ``[lo, hi)`` (``is_range``) or
    a sorted unique int64 index set.  ``n`` is the keyspace size; a set
    whose indices happen to be contiguous normalizes to a range, so the
    device fast path triggers whenever it can.
    """

    __slots__ = ("lo", "hi", "_idx", "n")

    def __init__(self, lo: int, hi: int, idx: Optional[np.ndarray], n: int):
        self.lo = lo
        self.hi = hi
        self._idx = idx
        self.n = n

    @staticmethod
    def from_range(lo: int, hi: int, n: int) -> "Compiled":
        lo = int(max(0, min(lo, n)))
        hi = int(max(lo, min(hi, n)))
        return Compiled(lo, hi, None, n)

    @staticmethod
    def from_indices(idx, n: int, *, validate: bool = True) -> "Compiled":
        idx = np.unique(np.asarray(idx, dtype=np.int64))
        if validate and len(idx) and (idx[0] < 0 or idx[-1] >= n):
            raise IndexError(
                f"positions {idx[[0, -1]].tolist()} out of range for "
                f"keyspace of size {n}")
        if len(idx) == 0:
            return Compiled.from_range(0, 0, n)
        if int(idx[-1]) - int(idx[0]) + 1 == len(idx):  # contiguous ⇒ range
            return Compiled.from_range(int(idx[0]), int(idx[-1]) + 1, n)
        # Compiled objects are cached process-wide: freeze the index set so
        # a caller mutating positions() cannot poison later identical queries
        idx.setflags(write=False)
        return Compiled(int(idx[0]), int(idx[-1]) + 1, idx, n)

    @property
    def is_range(self) -> bool:
        return self._idx is None

    @property
    def count(self) -> int:
        return (self.hi - self.lo) if self.is_range else len(self._idx)

    def positions(self) -> np.ndarray:
        """Sorted int64 positions into the keyspace."""
        if self.is_range:
            return np.arange(self.lo, self.hi, dtype=np.int64)
        return self._idx

    def mask(self) -> np.ndarray:
        """Boolean membership mask over the whole keyspace (len == n)."""
        m = np.zeros(self.n, dtype=bool)
        if self.is_range:
            m[self.lo:self.hi] = True
        else:
            m[self._idx] = True
        return m

    def runs(self, max_runs: int = 4) -> Optional[list]:
        """Decompose into ≤``max_runs`` contiguous ``[lo, hi)`` intervals.

        A range is its own single run; a scattered index set splits at the
        gaps.  Returns ``None`` when more than ``max_runs`` intervals would
        be needed — the caller falls back to a membership gather.  This is
        the multi-interval extension of the ``from_indices`` contiguous⇒
        range normalization: a ``Match``/``Where`` whose hits form a few
        rank intervals runs as a few range-kernel calls instead of a
        gather (see ``plan_boxes``).
        """
        if self.is_range:
            return [(self.lo, self.hi)]
        idx = self._idx
        breaks = np.flatnonzero(np.diff(idx) > 1)
        if len(breaks) + 1 > max_runs:
            return None
        starts = np.concatenate(([0], breaks + 1))
        ends = np.concatenate((breaks, [len(idx) - 1]))
        return [(int(idx[s]), int(idx[e]) + 1)
                for s, e in zip(starts, ends)]

    def __repr__(self) -> str:
        if self.is_range:
            return f"Compiled(range=[{self.lo},{self.hi}), n={self.n})"
        return f"Compiled(set={self.count} of {self.n})"


def plan_boxes(rc: Compiled, cc: Compiled, nr: int, nc: int,
               max_boxes: int = 4):
    """Device selection dispatch plan: rank boxes + residual gather flags.

    Returns ``(boxes, row_gather, col_gather)`` where ``boxes`` is an
    int32 ``[k, 4]`` array of ``(rlo, rhi, clo, chi)`` range-kernel
    bounds, ``k ≤ max_boxes``, and each ``*_gather`` flag marks an axis
    that still needs a membership gather.  The keep mask is the OR of the
    per-box range-kernel masks ANDed with any gathers — the boxes are
    disjoint by construction (interval runs of sorted unique indices), so
    OR-composition is exact and no merge of extracted lists is needed.

    Preference order: both axes interval-decomposable and the box product
    fits → pure multi-range (no gathers); one axis decomposable → its
    runs as boxes (other bound open) + one gather; neither → one full box
    + two gathers (the caller's plain gather path).
    """
    r_runs = rc.runs(max_boxes)
    c_runs = cc.runs(max_boxes)
    if (r_runs is not None and c_runs is not None
            and len(r_runs) * len(c_runs) <= max_boxes):
        boxes = [(rl, rh, cl, ch) for rl, rh in r_runs for cl, ch in c_runs]
        return np.asarray(boxes, np.int32).reshape(-1, 4), False, False
    if r_runs is not None and len(r_runs) <= max_boxes:
        boxes = [(rl, rh, 0, nc) for rl, rh in r_runs]
        return np.asarray(boxes, np.int32), False, True
    if c_runs is not None and len(c_runs) <= max_boxes:
        boxes = [(0, nr, cl, ch) for cl, ch in c_runs]
        return np.asarray(boxes, np.int32), True, False
    return (np.asarray([(0, nr, 0, nc)], np.int32), True, True)


def _and_compiled(a: Compiled, b: Compiled) -> Compiled:
    if a.is_range and b.is_range:
        return Compiled.from_range(max(a.lo, b.lo), min(a.hi, b.hi), a.n)
    # timsort-merge sorted intersection (see sorted_ops.sorted_intersect)
    k, _, _ = sorted_intersect(a.positions(), b.positions())
    return Compiled.from_indices(k, a.n, validate=False)


def _or_compiled(a: Compiled, b: Compiled) -> Compiled:
    # empty is the identity: keeps single-range operands (e.g. one-prefix
    # StartsWith folds) on the range fast path instead of materializing
    if a.count == 0:
        return b
    if b.count == 0:
        return a
    if a.is_range and b.is_range and a.lo <= b.hi and b.lo <= a.hi:
        return Compiled.from_range(min(a.lo, b.lo), max(a.hi, b.hi), a.n)
    k, _, _ = sorted_union(a.positions(), b.positions())
    return Compiled.from_indices(k, a.n, validate=False)


def _not_compiled(a: Compiled) -> Compiled:
    return Compiled.from_indices(np.flatnonzero(~a.mask()), a.n,
                                 validate=False)


# ---------------------------------------------------------------------------
# Selector objects
# ---------------------------------------------------------------------------

class Selector:
    """Base class: composable, hashable-keyed, compiles per KeySpace."""

    def __and__(self, other) -> "Selector":
        return And(self, as_selector(other))

    def __rand__(self, other) -> "Selector":
        return And(as_selector(other), self)

    def __or__(self, other) -> "Selector":
        return Or(self, as_selector(other))

    def __ror__(self, other) -> "Selector":
        return Or(as_selector(other), self)

    def __invert__(self) -> "Selector":
        return Not(self)

    # hashable identity used by the per-KeySpace compilation cache
    def cache_key(self) -> tuple:
        raise NotImplementedError

    def _compile(self, space: KeySpace) -> Compiled:
        raise NotImplementedError


class All(Selector):
    """Every key (the ``:`` selector)."""

    def cache_key(self) -> tuple:
        return ("all",)

    def _compile(self, space: KeySpace) -> Compiled:
        return Compiled.from_range(0, len(space), len(space))

    def __repr__(self):
        return "All()"


class Keys(Selector):
    """Explicit key list (D4M ``'a,b,c,'``); unknown keys are ignored."""

    def __init__(self, keys):
        self.keys = sanitize_keys(keys)

    def cache_key(self) -> tuple:
        # dtype.str encodes the itemsize: without it, UTF-32 payloads of
        # different key lists (e.g. ['ab'] vs ['a','b']) collide
        return ("keys", self.keys.dtype.str, len(self.keys),
                _payload_digest(self.keys.tobytes()))

    def _compile(self, space: KeySpace) -> Compiled:
        arr = self.keys
        if space.is_string:
            arr = arr.astype(str)
        elif arr.dtype.kind in ("U", "S", "O"):
            try:
                arr = arr.astype(np.float64)
            except ValueError:
                return Compiled.from_range(0, 0, len(space))
        ranks, found = space.rank(arr, strict=False)
        del found
        return Compiled.from_indices(ranks, len(space), validate=False)

    def __repr__(self):
        return f"Keys({self.keys.tolist()!r})"


class Positions(Selector):
    """Integer *positions* into the sorted key array (paper rule 2)."""

    def __init__(self, pos: Union[slice, int, Sequence, np.ndarray]):
        if isinstance(pos, (int, np.integer)):
            pos = np.asarray([int(pos)], dtype=np.int64)
        if not isinstance(pos, slice):
            pos = np.asarray(pos, dtype=np.int64).ravel()
        self.pos = pos

    def cache_key(self) -> tuple:
        if isinstance(self.pos, slice):
            return ("pos_slice", self.pos.start, self.pos.stop, self.pos.step)
        return ("pos", len(self.pos), _payload_digest(self.pos.tobytes()))

    def _compile(self, space: KeySpace) -> Compiled:
        n = len(space)
        if isinstance(self.pos, slice):
            return Compiled.from_indices(np.arange(n, dtype=np.int64)[self.pos],
                                         n, validate=False)
        pos = self.pos
        neg = pos < 0
        if neg.any():
            pos = np.where(neg, pos + n, pos)
        return Compiled.from_indices(pos, n)

    def __repr__(self):
        return f"Positions({self.pos!r})"


class Range(Selector):
    """D4M key range ``'lo,:,hi,'`` — inclusive on both ends by default.

    Open ends are ``None``.  Exclusive bounds use the prev/next-string
    trick the paper's string slices rely on: an exclusive lower bound
    starts *after* the last key equal to ``lo`` (``searchsorted right``),
    an exclusive upper bound stops *before* the first key equal to ``hi``
    (``searchsorted left``) — no literal successor strings are ever built.
    """

    def __init__(self, lo=None, hi=None, *, inclusive: Tuple[bool, bool] = (True, True)):
        self.lo = lo
        self.hi = hi
        self.inclusive = (bool(inclusive[0]), bool(inclusive[1]))

    def cache_key(self) -> tuple:
        # open bounds get a distinct tag: str(None) would collide with the
        # literal key "None" (a common stringified null in ingested data)
        lo = ("open",) if self.lo is None else ("key", str(self.lo))
        hi = ("open",) if self.hi is None else ("key", str(self.hi))
        return ("range", lo, hi, self.inclusive)

    def _compile(self, space: KeySpace) -> Compiled:
        n = len(space)
        keys = space.keys

        def cast(x):
            return str(x) if space.is_string else float(x)

        lo_i = 0
        hi_i = n
        try:
            if self.lo is not None:
                side = "left" if self.inclusive[0] else "right"
                lo_i = int(np.searchsorted(keys, cast(self.lo), side=side))
            if self.hi is not None:
                side = "right" if self.inclusive[1] else "left"
                hi_i = int(np.searchsorted(keys, cast(self.hi), side=side))
        except ValueError:   # string bounds against a numeric keyspace
            return Compiled.from_range(0, 0, n)
        return Compiled.from_range(lo_i, hi_i, n)

    def __repr__(self):
        return f"Range({self.lo!r}, {self.hi!r}, inclusive={self.inclusive})"


class StartsWith(Selector):
    """Prefix query (D4M ``StartsWith('ab,')``); accepts a prefix list.

    Each prefix compiles to the rank range ``[prefix, next(prefix))``
    where ``next`` increments the final character — the classic
    next-string boundary, computed on the *prefix*, never on the keys.
    """

    def __init__(self, prefixes):
        if isinstance(prefixes, str):
            prefixes = split_string_list(prefixes)
        self.prefixes = tuple(str(p) for p in prefixes)

    def cache_key(self) -> tuple:
        return ("startswith", self.prefixes)

    @staticmethod
    def _next_string(p: str) -> Optional[str]:
        """Smallest string that is greater than every string prefixed by p."""
        chars = list(p)
        while chars:
            o = ord(chars[-1])
            if o < 0x10FFFF:
                chars[-1] = chr(o + 1)
                return "".join(chars)
            chars.pop()  # carry past a maximal code point
        return None      # every string starts with p ⇒ open upper end

    def _compile(self, space: KeySpace) -> Compiled:
        if not space.is_string:
            raise TypeError("StartsWith requires a string keyspace")
        n = len(space)
        out = Compiled.from_range(0, 0, n)
        for p in self.prefixes:
            if p == "":
                return Compiled.from_range(0, n, n)
            lo = int(np.searchsorted(space.keys, p, side="left"))
            nxt = self._next_string(p)
            hi = n if nxt is None else int(
                np.searchsorted(space.keys, nxt, side="left"))
            out = _or_compiled(out, Compiled.from_range(lo, hi, n))
        return out

    def __repr__(self):
        return f"StartsWith({list(self.prefixes)!r})"


class Match(Selector):
    """Regex query over the (stringified) keys — ``re.search`` semantics."""

    def __init__(self, pattern: str, flags: int = 0):
        self.pattern = pattern
        self.flags = flags
        self._rx = re.compile(pattern, flags)

    def cache_key(self) -> tuple:
        return ("match", self.pattern, self.flags)

    def _compile(self, space: KeySpace) -> Compiled:
        keys = space.keys if space.is_string else space.keys.astype(str)
        hits = np.fromiter((self._rx.search(k) is not None for k in keys),
                           dtype=bool, count=len(keys))
        return Compiled.from_indices(np.flatnonzero(hits), len(space),
                                     validate=False)

    def __repr__(self):
        return f"Match({self.pattern!r})"


class Where(Selector):
    """Arbitrary per-key predicate.  Never cached: per-query lambdas would
    fill the cache with dead entries (and pin their closures) without ever
    hitting — and compilation is the predicate loop itself anyway."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def cache_key(self) -> tuple:
        raise TypeError("Where selectors compile uncached")

    def _compile(self, space: KeySpace) -> Compiled:
        fn = self.fn
        hits = np.fromiter((bool(fn(k)) for k in space.keys.tolist()),
                           dtype=bool, count=len(space))
        return Compiled.from_indices(np.flatnonzero(hits), len(space),
                                     validate=False)

    def __repr__(self):
        return f"Where({self.fn!r})"


class Mask(Selector):
    """Boolean membership mask over the keyspace (len == len(space))."""

    def __init__(self, mask):
        self.bits = np.asarray(mask, dtype=bool).ravel()

    def cache_key(self) -> tuple:
        return ("mask", len(self.bits), _payload_digest(self.bits.tobytes()))

    def _compile(self, space: KeySpace) -> Compiled:
        if len(self.bits) != len(space):
            raise ValueError(
                f"Mask of length {len(self.bits)} against keyspace of "
                f"size {len(space)}")
        return Compiled.from_indices(np.flatnonzero(self.bits), len(space),
                                     validate=False)

    def __repr__(self):
        return f"Mask(n={len(self.bits)}, count={int(self.bits.sum())})"


class And(Selector):
    def __init__(self, a: Selector, b: Selector):
        self.a, self.b = a, b

    def cache_key(self) -> tuple:
        return ("and", self.a.cache_key(), self.b.cache_key())

    def _compile(self, space: KeySpace) -> Compiled:
        return _and_compiled(compile_selector(self.a, space),
                             compile_selector(self.b, space))

    def __repr__(self):
        return f"({self.a!r} & {self.b!r})"


class Or(Selector):
    def __init__(self, a: Selector, b: Selector):
        self.a, self.b = a, b

    def cache_key(self) -> tuple:
        return ("or", self.a.cache_key(), self.b.cache_key())

    def _compile(self, space: KeySpace) -> Compiled:
        return _or_compiled(compile_selector(self.a, space),
                            compile_selector(self.b, space))

    def __repr__(self):
        return f"({self.a!r} | {self.b!r})"


class Not(Selector):
    def __init__(self, a: Selector):
        self.a = a

    def cache_key(self) -> tuple:
        return ("not", self.a.cache_key())

    def _compile(self, space: KeySpace) -> Compiled:
        return _not_compiled(compile_selector(self.a, space))

    def __repr__(self):
        return f"~{self.a!r}"


# ---------------------------------------------------------------------------
# Parsing raw __getitem__ arguments → Selector
# ---------------------------------------------------------------------------

def as_selector(sel) -> Selector:
    """Coerce any D4M index argument into a Selector.

    Paper rules, uniform across layers:
      * ``:`` / ``slice`` / ints / int arrays / int 2-tuples — *positions*
        into the sorted key array (rule 2);
      * strings — key lists (``'a,b,'``), ranges (``'a,:,b,'``), or a
        single key;
      * key-payload 2-tuples — inclusive key ranges;
      * bool arrays — membership masks;
      * float / string arrays — explicit key lookups;
      * Selector instances pass through.

    Selections are *order-free sets*: every selector compiles to a sorted
    unique position set (or range), so reversed slices and duplicate
    positions normalize — results are always in canonical key order.
    """
    if isinstance(sel, Selector):
        return sel
    if isinstance(sel, slice):
        if sel == slice(None):
            return All()
        return Positions(sel)
    if isinstance(sel, (bool, np.bool_)):
        raise TypeError("a bare bool is not a selector")
    if isinstance(sel, (int, np.integer)):
        return Positions(int(sel))
    if isinstance(sel, str):
        if sel == ":":
            return All()
        parts = split_string_list(sel)
        if len(parts) == 3 and parts[1] == ":":
            return Range(parts[0], parts[2])
        return Keys(parts)
    if isinstance(sel, tuple) and len(sel) == 2:
        # int payloads keep the paper's uniform ints-are-POSITIONS rule
        # (matching list/array forms); key payloads are an inclusive Range
        if all(isinstance(x, (int, np.integer)) and not isinstance(x, bool)
               for x in sel):
            return Positions(np.asarray(sel, dtype=np.int64))
        return Range(sel[0], sel[1])
    arr = np.asarray(sel)
    if arr.dtype.kind == "b":
        return Mask(arr)
    if arr.dtype.kind in "iu":
        # integer selectors are POSITIONS (paper rule 2) — uniformly,
        # whether given as a python list or a numpy array
        return Positions(arr)
    return Keys(arr)


# ---------------------------------------------------------------------------
# Compilation cache (per KeySpace): keyspaces are immutable and content-
# hashed, so (digest, selector-key) fully determines the compiled form.
# ---------------------------------------------------------------------------

_COMPILE_CACHE: "OrderedDict" = OrderedDict()
_CACHE_CAP = 4096

CACHE_STATS = {"hits": 0, "misses": 0}

# Guards the LRU mutation + counter bumps: the serve engine compiles
# selectors from many worker threads, and concurrent move_to_end/popitem
# corrupts the OrderedDict.
_COMPILE_LOCK = threading.RLock()


def clear_compile_cache() -> None:
    """Drop all cached compilations and zero the counters (mirrors
    ``keyspace.clear_union_cache``)."""
    with _COMPILE_LOCK:
        _COMPILE_CACHE.clear()
        reset_cache_stats()


def reset_cache_stats() -> None:
    with _COMPILE_LOCK:
        CACHE_STATS["hits"] = 0
        CACHE_STATS["misses"] = 0


def invalidate_compiled_for(digests) -> int:
    """Drop compiled selectors keyed on any of ``digests`` (KeySpace content
    hashes).  Ingest compaction retires a table's old keyspaces; their
    compiled selectors can never be *wrong* (content-keyed), but they pin
    rank tables for spaces no live table uses, so compaction sheds them."""
    stale = set(digests)
    if not stale:
        return 0
    with _COMPILE_LOCK:
        drop = [k for k in _COMPILE_CACHE if k[0] in stale]
        for k in drop:
            del _COMPILE_CACHE[k]
    return len(drop)


def compile_selector(sel, space: KeySpace) -> Compiled:
    """Compile a selector (or raw index argument) against a KeySpace."""
    sel = as_selector(sel)
    try:
        key = (space.digest, sel.cache_key())
    except TypeError:        # unhashable component: compile uncached
        return sel._compile(space)
    with _COMPILE_LOCK:
        hit = _COMPILE_CACHE.get(key)
        if hit is not None:
            CACHE_STATS["hits"] += 1
            _COMPILE_CACHE.move_to_end(key)  # LRU: refresh on hit
            return hit
    # _compile outside the lock: it is pure, so racing threads at worst
    # compile the same key twice and the second insert is a no-op.
    comp = sel._compile(space)
    with _COMPILE_LOCK:
        CACHE_STATS["misses"] += 1
        if key not in _COMPILE_CACHE:
            while len(_COMPILE_CACHE) >= _CACHE_CAP:
                _COMPILE_CACHE.popitem(last=False)   # evict LRU, no cliff
            _COMPILE_CACHE[key] = comp
    return comp
