"""Sorted-set primitives: union / intersection with index maps.

These are the paper's §II.C building blocks.  The paper constructs the sorted
union/intersection of two repetition-free sorted key arrays with a scalar
merge loop, recording *index maps* describing how each input embeds into the
result.  Those index maps are what lets ``A.adj`` / ``B.adj`` be re-indexed
onto the combined key space so a single bulk sparse-linear-algebra call
finishes the job.

Two implementations:

* ``sorted_union`` / ``sorted_intersect`` — host (numpy) reference with the
  exact semantics of the paper's merge loop, but vectorized via two-sided
  ``searchsorted`` (no Python-level loop; this is already the first
  device-minded rewrite and is what the host ``Assoc`` uses).
* ``sorted_union_padded`` / ``sorted_intersect_padded`` — shape-static
  torch versions for fixed-capacity device arrays (sentinel-padded) that
  never leave the device (no host synchronisation).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "sorted_union",
    "sorted_intersect",
    "sorted_union_padded",
    "sorted_intersect_padded",
    "INT_SENTINEL",
]

# Padding sentinel for int32 rank arrays: sorts after every valid rank.
INT_SENTINEL = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# Host (numpy) — used by the paper-faithful Assoc
# ---------------------------------------------------------------------------

def sorted_union(i: np.ndarray, j: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted union of two repetition-free sorted arrays with index maps.

    Returns ``(k, i_map, j_map)`` where ``k`` is the sorted union and
    ``k[i_map] == i`` and ``k[j_map] == j`` elementwise (the paper's "how I
    and J sit within K").

    The concatenation of two sorted runs is merged with a *stable* sort
    (timsort gallops through presorted runs in ~O(n)) rather than
    ``np.union1d``'s full introsort — noticeably cheaper for the string key
    arrays the host ``Assoc`` unions on every element-wise op.
    """
    i = np.asarray(i)
    j = np.asarray(j)
    k = np.concatenate([i, j])
    k.sort(kind="stable")  # two presorted runs: timsort merge, ~O(n)
    if len(k):
        k = k[np.r_[True, k[1:] != k[:-1]]]
    i_map = np.searchsorted(k, i)
    j_map = np.searchsorted(k, j)
    return k, i_map, j_map


def sorted_intersect(i: np.ndarray, j: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted intersection with index maps *into the inputs*.

    Returns ``(k, i_map, j_map)`` with ``i[i_map] == k`` and ``j[j_map] == k``
    (the paper records how K sits within I and J).

    Same timsort trick as :func:`sorted_union`: the concatenation of two
    sorted repetition-free runs is merged with a *stable* sort (timsort
    gallops through presorted runs in ~O(n)); an element appears twice in
    the merge iff it lies in both inputs, so adjacent duplicates ARE the
    intersection — no ``np.intersect1d`` re-sort.
    """
    i = np.asarray(i)
    j = np.asarray(j)
    k = np.concatenate([i, j])
    k.sort(kind="stable")  # two presorted runs: timsort merge, ~O(n)
    k = k[:-1][k[1:] == k[:-1]] if len(k) else k
    i_map = np.searchsorted(i, k)
    j_map = np.searchsorted(j, k)
    return k, i_map, j_map


# ---------------------------------------------------------------------------
# Device (torch, shape-static) — used by AssocTensor
#
# Inputs are int32 rank tensors of static length, sorted ascending, padded at
# the tail with INT_SENTINEL.  Outputs have static capacity len(i)+len(j)
# (union) / min(len(i), len(j)) (intersection), padded the same way, plus the
# actual count as a 0-dim int32 tensor.
# ---------------------------------------------------------------------------

def sorted_union_padded(i: torch.Tensor, j: torch.Tensor):
    """Shape-static sorted union of sentinel-padded sorted int32 tensors.

    Returns ``(k, nk, i_map, j_map)``:
      * ``k``:  int32[len(i)+len(j)] sorted union, sentinel-padded,
      * ``nk``: int32 0-dim count of valid entries,
      * ``i_map``/``j_map``: positions of each input element within ``k``
        (sentinel positions map to the tail and are masked by callers).

    Element ``i[m]`` lands at ``m + (# j strictly below it)`` and ``j[n]``
    at ``n + (# i at-or-below it)``; a j element equal to an i element
    lands on the i copy's slot, and a stable partition compacts the union.
    """
    ni_cap, nj_cap = i.shape[0], j.shape[0]
    cap = ni_cap + nj_cap
    dev = i.device
    sent = int(INT_SENTINEL)
    i = i.to(torch.int32).contiguous()
    j = j.to(torch.int32).contiguous()

    i_in_j = torch.searchsorted(j, i, right=False)   # # of j strictly less
    j_in_i = torch.searchsorted(i, j, right=True)    # # of i less-or-equal
    i_pos = torch.arange(ni_cap, device=dev) + i_in_j
    j_pos = torch.arange(nj_cap, device=dev) + j_in_i
    j_dup = (j_in_i > 0) & (i[(j_in_i - 1).clamp(0, max(ni_cap - 1, 0))] == j) \
        if ni_cap else torch.zeros(nj_cap, dtype=torch.bool, device=dev)
    j_pos = torch.where(j_dup, j_pos - 1, j_pos)

    merged = torch.full((cap,), sent, dtype=torch.int32, device=dev)
    merged[i_pos] = i
    merged[j_pos] = j

    slot_valid = merged != sent
    order = torch.sort((~slot_valid).to(torch.int8), stable=True).indices
    k = merged[order]
    nk = slot_valid.sum().to(torch.int32)

    inv = torch.empty(cap, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(cap, device=dev)
    i_map = torch.where(i == sent, cap - 1, inv[i_pos]).to(torch.int32)
    j_map = torch.where(j == sent, cap - 1, inv[j_pos]).to(torch.int32)
    return k, nk, i_map, j_map


def sorted_intersect_padded(i: torch.Tensor, j: torch.Tensor):
    """Shape-static sorted intersection of sentinel-padded sorted tensors.

    Returns ``(k, nk, i_map, j_map)`` with capacity ``min(len(i), len(j))``;
    ``i_map``/``j_map`` give, for each valid ``k[t]``, its position in ``i``
    / ``j`` (tail positions are 0 and masked by ``t < nk``).
    """
    cap = min(i.shape[0], j.shape[0])
    dev = i.device
    sent = int(INT_SENTINEL)
    i = i.to(torch.int32).contiguous()
    j = j.to(torch.int32).contiguous()

    pos_in_j = torch.searchsorted(j, i, right=False)
    if j.shape[0]:
        hit = (pos_in_j < j.shape[0]) & (
            j[pos_in_j.clamp(0, j.shape[0] - 1)] == i)
    else:
        hit = torch.zeros(i.shape[0], dtype=torch.bool, device=dev)
    hit = hit & (i != sent)

    order = torch.sort((~hit).to(torch.int8), stable=True).indices[:cap]
    nk = hit.sum().to(torch.int32)
    valid = torch.arange(cap, device=dev) < nk
    k = torch.where(valid, i[order], sent).to(torch.int32)
    i_map = torch.where(valid, order, 0).to(torch.int32)
    j_map = torch.where(valid, pos_in_j[order], 0).to(torch.int32)
    return k, nk, i_map, j_map
