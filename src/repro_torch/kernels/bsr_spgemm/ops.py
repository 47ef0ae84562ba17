"""Pair-list BSR contractions (kernel or plain version) and the block mask.

The pair lists come from the planner (:func:`repro_torch.core.spgemm.plan_matmul`)
and MUST arrive grouped (sorted) by ``pair_c`` / ``pair_o``: the wrapper
turns the sorted output ids into run offsets, and the CUDA kernel
(``csrc/bsr_pairlist.cu``) gives each run to one block.  ``impl="auto"``
launches the kernel on CUDA tensors and the plain version on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.kernels import cuda_lib
from .ref import (bsr_pairlist_ref, bsr_pairlist_reduce_ref,
                  bsr_spgemm_reduce_ref)

TILE = 128


def make_block_mask(rows, cols, valid, mb: int, kb: int, *, bm=128, bk=128):
    """Per-tile presence mask from COO coordinates (int32 [MB, KB])."""
    dev = rows.device
    r = torch.where(valid, rows.to(torch.int64) // bm, mb)
    c = torch.where(valid, cols.to(torch.int64) // bk, kb)
    mask = torch.zeros((mb + 1) * (kb + 1), dtype=torch.int32, device=dev)
    mask.index_add_(0, (r * (kb + 1) + c).reshape(-1),
                    torch.ones(r.numel(), dtype=torch.int32, device=dev))
    return (mask.view(mb + 1, kb + 1)[:mb, :kb] > 0).to(torch.int32)


def run_offsets(pair_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [n+1]: run t of the sorted output ids is
    ``[offsets[t], offsets[t+1])``."""
    ids = torch.arange(n + 1, dtype=torch.int32, device=pair_sorted.device)
    return torch.searchsorted(pair_sorted.to(torch.int32).contiguous(), ids,
                              out_int32=True)


def _check_pairlist(a_tiles, b_tiles, pair_a, pair_b, pair_x, n_out):
    """Validate what the kernel cannot: device, dtypes, shapes, and (one
    host read-back) that every pair indexes a tile and the output ids are
    sorted within ``[0, n_out)`` — a bad index would read out of bounds."""
    cuda_lib.check_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_x)
    for name, t in (("a_tiles", a_tiles), ("b_tiles", b_tiles)):
        if t.dim() != 3 or t.shape[1:] != (TILE, TILE) \
                or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [n, {TILE}, {TILE}]; "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = pair_a.shape[0]
    for name, t in (("pair_a", pair_a), ("pair_b", pair_b),
                    ("pair_c/o", pair_x)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be int32 [{n}]; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if n:
        bad = torch.stack([
            (pair_a.min() < 0) | (pair_a.max() >= a_tiles.shape[0]),
            (pair_b.min() < 0) | (pair_b.max() >= b_tiles.shape[0]),
            (pair_x.min() < 0) | (pair_x.max() >= n_out),
            (pair_x[1:] < pair_x[:-1]).any()]).tolist()
        if any(bad):
            raise ValueError(
                "pair lists out of range or unsorted (pair_a, pair_b, "
                f"pair_c/o range, pair_c/o order): {bad}")
    return (a_tiles.contiguous(), b_tiles.contiguous(),
            pair_a.contiguous(), pair_b.contiguous())


def bsr_pairlist_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_c, *,
                      n_c: int, sr: Semiring) -> torch.Tensor:
    """The kernel: packed C tiles ``[n_c, 128, 128]``."""
    a_tiles, b_tiles, pair_a, pair_b = _check_pairlist(
        a_tiles, b_tiles, pair_a, pair_b, pair_c, n_c)
    runs = run_offsets(pair_c, n_c)
    c_tiles = torch.empty((n_c, TILE, TILE), dtype=torch.float32,
                          device=a_tiles.device)
    if n_c == 0:                  # no grid to launch: nothing to count
        return c_tiles
    cuda_lib.launch("bsr_pairlist", cuda_lib.SEMIRING_IDS[sr.name],
                    a_tiles.data_ptr(), b_tiles.data_ptr(), pair_a.data_ptr(),
                    pair_b.data_ptr(), runs.data_ptr(), c_tiles.data_ptr(),
                    n_c, cuda_lib.stream_ptr(a_tiles))
    return c_tiles


def bsr_pairlist_reduce_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                             n_o: int, axis: int, sr: Semiring) -> torch.Tensor:
    """The kernel: per-output-block ⊕-folded vectors ``[n_o, 128]``."""
    a_tiles, b_tiles, pair_a, pair_b = _check_pairlist(
        a_tiles, b_tiles, pair_a, pair_b, pair_o, n_o)
    runs = run_offsets(pair_o, n_o)
    out = torch.empty((n_o, TILE), dtype=torch.float32, device=a_tiles.device)
    if n_o == 0:                  # no grid to launch: nothing to count
        return out
    cuda_lib.launch("bsr_pairlist_reduce", cuda_lib.SEMIRING_IDS[sr.name],
                    a_tiles.data_ptr(), b_tiles.data_ptr(), pair_a.data_ptr(),
                    pair_b.data_ptr(), runs.data_ptr(), out.data_ptr(),
                    n_o, axis, cuda_lib.stream_ptr(a_tiles))
    return out


def bsr_pairlist(a_tiles, b_tiles, pair_a, pair_b, pair_c, *, n_c: int,
                 semiring="plus_times", impl="auto") -> torch.Tensor:
    """Pair-list BSR contraction → packed C tiles ``[n_c, bm, bn]``."""
    sr = get_semiring(semiring)
    if cuda_lib.resolve_impl(impl, a_tiles) == "ref":
        return bsr_pairlist_ref(a_tiles, b_tiles, pair_a, pair_b, pair_c,
                                n_c=n_c, semiring=sr)
    return bsr_pairlist_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_c,
                             n_c=n_c, sr=sr)


def bsr_pairlist_reduce(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                        n_o: int, axis: int, semiring="plus_times",
                        impl="auto") -> torch.Tensor:
    """Fused pair-list ``⊕-reduce(A ⊗.⊕ B, axis)`` → ``[n_o, 128]``
    per-output-block vectors (block-rows for axis=1, block-cols for 0).

    C tiles never exist: the kernel folds each run's products into one
    vector per output block.
    """
    sr = get_semiring(semiring)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    if cuda_lib.resolve_impl(impl, a_tiles) == "ref":
        return bsr_pairlist_reduce_ref(a_tiles, b_tiles, pair_a, pair_b,
                                       pair_o, n_o=n_o, axis=axis,
                                       semiring=sr)
    return bsr_pairlist_reduce_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_o,
                                    n_o=n_o, axis=axis, sr=sr)


def bsr_spgemm_reduce(a, block_mask, b, *, axis: int,
                      semiring="plus_times", impl="auto"):
    """Fused ``⊕-reduce(A ⊗.⊕ B, axis)`` over a block-masked dense A →
    vector ([M] for axis=1, [N] for axis=0).

    Only the plain version exists: the fused CUDA kernel (the port of
    ``bsr_spgemm_reduce_pallas``) is not written yet, so CUDA tensors
    raise ``NotImplementedError`` instead of silently running the
    materializing plain version on the card.
    """
    sr = get_semiring(semiring)
    if cuda_lib.resolve_impl(impl, a) == "cuda":
        raise NotImplementedError(
            "bsr_spgemm_reduce (the dense-strategy fused reduce kernel) is "
            "not ported to CUDA yet; use impl='bsr' or impl='coo' for "
            "matmul_reduce on CUDA tensors")
    return bsr_spgemm_reduce_ref(a, block_mask, b, axis=axis, semiring=sr)
