"""Host-side key dictionaries for device associative arrays.

Device code cannot hold strings or dynamically-growing key sets, so the
device representation (``AssocTensor``) stores **int32 ranks** into a
host-side sorted unique key array — the paper's string-value pointer scheme
(``adj[i,j] = k+1`` into sorted ``A.val``) promoted to a general mechanism
for rows, columns *and* values.

Because the key array is sorted, rank order ⇔ lexicographic order, so
order-theoretic semiring ops (min/max under dictionary order) act directly on
ranks on device.  Range queries (D4M's right-inclusive string slices) resolve
on host to a rank interval, executed on device as an integer mask.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["KeySpace", "UNION_STATS", "clear_union_cache"]

# Memoized keyspace unions: keyspaces are immutable and content-hashed, so
# (digest_a, digest_b) fully determines (merged, self_map, other_map).
# Repeated ops on the same array pair — the common case in iterated algebra
# and selector queries — skip the merge entirely (ROADMAP "amortize
# keyspace unions").  LRU-evicted: entries pin full merged keyspaces, so
# the bound must shed cold pairs without a clear-all cliff.
_UNION_CACHE: "OrderedDict" = OrderedDict()
_UNION_CACHE_CAP = 256

UNION_STATS = {"hits": 0, "misses": 0, "evictions": 0}

# Guards LRU mutation + counter bumps under concurrent union() calls
# (serve workers union keyspaces from many threads).
_UNION_LOCK = threading.RLock()


def clear_union_cache() -> None:
    with _UNION_LOCK:
        _UNION_CACHE.clear()
        UNION_STATS["hits"] = 0
        UNION_STATS["misses"] = 0
        UNION_STATS["evictions"] = 0


class KeySpace:
    """An immutable sorted-unique key dictionary (host side)."""

    def __init__(self, keys):
        arr = np.asarray(keys)
        if arr.dtype.kind in ("U", "S", "O"):
            arr = arr.astype(str)
        else:
            arr = arr.astype(np.float64)
        self.keys = np.unique(arr)  # sorted unique
        self._digest = self._compute_digest(self.keys)

    @staticmethod
    def _compute_digest(keys: np.ndarray) -> str:
        # dtype.str + length disambiguate the fixed-width buffer: a plain
        # separator join would collide for keys containing the separator
        # (["a\x00b"] vs ["a", "b"]), and the digest is the sole identity
        # for the union/compile caches
        h = hashlib.sha1(f"{keys.dtype.str}:{len(keys)}:".encode())
        h.update(keys.tobytes())
        return h.hexdigest()

    @classmethod
    def from_sorted_unique(cls, keys: np.ndarray) -> "KeySpace":
        """Wrap an array that is already sorted-unique (skips ``np.unique``).

        The array object is kept by reference, so callers (e.g. the host
        ``Assoc``'s lazy per-axis keyspaces) can validate cache freshness
        with an identity check.
        """
        ks = cls.__new__(cls)
        ks.keys = keys
        ks._digest = cls._compute_digest(keys)
        return ks

    @property
    def digest(self) -> str:
        """Content hash — the compilation-cache key for this keyspace."""
        return self._digest

    # -- container protocol -------------------------------------------------
    def __len__(self) -> int:
        return len(self.keys)

    def __contains__(self, key) -> bool:
        return len(self.rank(np.asarray([key]), strict=False)[0]) == 1

    def __getitem__(self, rank):
        return self.keys[rank]

    # cache keys: cheap, content-based hash/eq
    def __hash__(self) -> int:
        return hash(self._digest)

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        return isinstance(other, KeySpace) and self._digest == other._digest

    def __repr__(self) -> str:
        return f"KeySpace(n={len(self)}, kind={self.keys.dtype.kind})"

    @property
    def is_string(self) -> bool:
        return self.keys.dtype.kind == "U"

    # -- rank mapping ---------------------------------------------------------
    def rank(self, keys, strict: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Map keys → int32 ranks.  Returns ``(ranks, found_mask)``.

        With ``strict=True`` unknown keys raise; otherwise they are filtered
        (mask reports which inputs were found).
        """
        arr = np.asarray(keys)
        if self.is_string:
            arr = arr.astype(str)
        pos = np.searchsorted(self.keys, arr)
        pos_c = np.clip(pos, 0, max(len(self.keys) - 1, 0))
        found = (self.keys[pos_c] == arr) if len(self.keys) else np.zeros(arr.shape, bool)
        if strict and not found.all():
            missing = arr[~found][:5]
            raise KeyError(f"keys not in KeySpace: {missing!r}")
        return pos_c[found].astype(np.int32) if not strict else pos_c.astype(np.int32), found

    def rank_range(self, lo, hi) -> Tuple[int, int]:
        """Right-inclusive D4M range ``lo ≤ k ≤ hi`` → half-open rank range."""
        lo_i = int(np.searchsorted(self.keys, lo, side="left"))
        hi_i = int(np.searchsorted(self.keys, hi, side="right"))
        return lo_i, hi_i

    # -- merging --------------------------------------------------------------
    def union(self, other: "KeySpace") -> Tuple["KeySpace", np.ndarray, np.ndarray]:
        """Merged keyspace + rank-translation tables for both inputs.

        ``self_map[r]`` is the rank in the union of the key with rank ``r``
        in ``self`` (likewise ``other_map``).  The translation tables are the
        host analogue of the paper's union index maps; uploading them lets
        the device re-rank an AssocTensor onto the merged space with one
        gather.
        """
        if self == other:
            eye = np.arange(len(self), dtype=np.int32)
            return self, eye, eye
        if self.is_string != other.is_string:
            raise TypeError("cannot merge string and numeric keyspaces")
        cache_key = (self._digest, other._digest)
        with _UNION_LOCK:
            hit = _UNION_CACHE.get(cache_key)
            if hit is not None:
                UNION_STATS["hits"] += 1
                _UNION_CACHE.move_to_end(cache_key)
                return hit
        # merge outside the lock (pure; a cold-key race just merges twice)
        merged = KeySpace(np.concatenate([self.keys, other.keys]))
        self_map = np.searchsorted(merged.keys, self.keys).astype(np.int32)
        other_map = np.searchsorted(merged.keys, other.keys).astype(np.int32)
        # cached tuples are shared across callers: freeze the maps so an
        # in-place tweak cannot poison later unions of the same pair
        self_map.setflags(write=False)
        other_map.setflags(write=False)
        with _UNION_LOCK:
            UNION_STATS["misses"] += 1
            if cache_key not in _UNION_CACHE:
                while len(_UNION_CACHE) >= _UNION_CACHE_CAP:
                    # streaming ingest mints fresh keyspaces every append
                    # batch — count sheds so sustained-mutation workloads
                    # can see the memo churning instead of helping
                    _UNION_CACHE.popitem(last=False)
                    UNION_STATS["evictions"] += 1
                _UNION_CACHE[cache_key] = (merged, self_map, other_map)
        return merged, self_map, other_map

    @staticmethod
    def integers(n: int) -> "KeySpace":
        """The keyspace {0.0, 1.0, ..., n-1} — ranks coincide with keys."""
        return KeySpace(np.arange(n, dtype=np.float64))
