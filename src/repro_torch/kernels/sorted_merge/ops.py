"""Sorted-set merge positions from rank counts (kernel or plain version).

``rank_count`` is the inner primitive of the ingest merge-on-read
(:mod:`repro_torch.ingest.merge`): for every element of sorted ``i`` it
counts the elements of sorted ``j`` below it and equal to it.
``merge_positions`` turns two such counts into union slots, and
``overlay_scatter`` routes sentinel entries to one out-of-bounds slot.
``impl="auto"`` launches the CUDA kernel (``csrc/rank_count.cu``) on CUDA
tensors and the plain version on CPU tensors.

Both follow the ``searchsorted`` contract on every entry, sentinels
included (the JAX package's Pallas path pads to block multiples and may
count its own pad sentinels for sentinel entries of ``i``; valid entries
agree, and ``overlay_scatter`` discards every sentinel slot either way).
"""
from __future__ import annotations

import torch

from repro_torch.core.sorted_ops import INT_SENTINEL
from repro_torch.kernels import cuda_lib
from .ref import rank_count_ref

SENT = int(INT_SENTINEL)


def rank_count_cuda(i: torch.Tensor, j: torch.Tensor):
    """The kernel: int32 sorted ``i`` [Ni] and ``j`` [Nj] on one sm_90
    card → int32 ``(rank, hit)`` [Ni], in one merge-path launch (after a
    memset of ``hit``).  Unsorted input gives wrong counts but never reads
    or writes out of bounds (every split lies inside both arrays)."""
    cuda_lib.check_cuda(i, j)
    if i.dtype != torch.int32 or j.dtype != torch.int32:
        raise TypeError("rank_count takes int32 i and j")
    if i.dim() != 1 or j.dim() != 1:
        raise ValueError(f"i {tuple(i.shape)} and j {tuple(j.shape)} must "
                         f"be 1-D")
    if i.shape[0] + j.shape[0] >= 2 ** 31:
        raise ValueError("rank_count takes fewer than 2^31 keys in all")
    i, j = i.contiguous(), j.contiguous()
    rank, hit = torch.empty((2, i.shape[0]), dtype=torch.int32,
                            device=i.device).unbind(0)   # one allocation
    if i.shape[0] == 0:           # no grid to launch: nothing to count
        return rank, hit
    cuda_lib.launch("rank_count", i.data_ptr(), j.data_ptr(), rank.data_ptr(),
                    hit.data_ptr(), i.shape[0], j.shape[0],
                    cuda_lib.stream_ptr(i))
    return rank, hit


def rank_count(i: torch.Tensor, j: torch.Tensor, *, impl: str = "auto"):
    """``(rank, hit)``: rank[m] = #{n : j[n] < i[m]}, hit[m] =
    #{n : j[n] == i[m]}, both int32 [Ni]."""
    if cuda_lib.resolve_impl(impl, i) == "ref":
        return rank_count_ref(i, j)
    return rank_count_cuda(i, j)


def merge_positions(i: torch.Tensor, j: torch.Tensor, *, impl: str = "auto"):
    """UNION positions for two sorted, repetition-free, sentinel-padded
    int32 arrays — duplicates collapse onto one shared slot.

    A duplicate shrinks the union by one, so every element also subtracts
    the number of collapsed pairs BELOW it: the exclusive cumsum of its own
    side's hit counts (both sides are sorted, so the pairs below i[m] are
    exactly the matched i's before m).  Returns ``(i_pos, j_pos, j_dup)``.
    """
    r_ij, hit_ij = rank_count(i, j, impl=impl)   # J below / matching each I
    r_ji, hit_ji = rank_count(j, i, impl=impl)   # I below / matching each J
    dup_below_i = torch.cumsum(hit_ij, 0, dtype=torch.int32) - hit_ij
    dup_below_j = torch.cumsum(hit_ji, 0, dtype=torch.int32) - hit_ji
    ar_i = torch.arange(i.shape[0], dtype=torch.int32, device=i.device)
    ar_j = torch.arange(j.shape[0], dtype=torch.int32, device=j.device)
    i_pos = ar_i + r_ij - dup_below_i
    j_pos = ar_j + r_ji - dup_below_j
    return i_pos, j_pos, hit_ji > 0


def overlay_scatter(i: torch.Tensor, j: torch.Tensor, *, impl: str = "auto"):
    """Union destination slots for an LSM overlay merge (base ⊕ delta).

    ``i``/``j`` are sorted, repetition-free, sentinel-padded int32 keys
    (base and delta linearized (row, col) keys).  Returns ``(i_dst, j_dst,
    j_dup)``: destinations into a ``len(i) + len(j)`` output where a key in
    both collapses onto one shared slot (``j_dup`` flags those delta
    entries, which ⊕-combine instead of overwrite), and every sentinel
    entry is routed to the out-of-bounds slot ``len(i) + len(j)``.  Torch
    has no scatter that drops indices, so callers scatter into one spare
    slot past the end and slice it off.
    """
    i_pos, j_pos, j_dup = merge_positions(i, j, impl=impl)
    oob = i.shape[0] + j.shape[0]
    i_dst = torch.where(i != SENT, i_pos, oob)
    j_dst = torch.where(j != SENT, j_pos, oob)
    return i_dst, j_dst, j_dup
