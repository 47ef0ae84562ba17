"""Block-sparse contractions (kernel or plain version) and the block mask.

The pair-list kernels back the ``bsr`` strategy; the block-masked dense
kernels (``csrc/bsr_spgemm.cu``) back the ``dense`` strategy's fused
reduce (``bsr_spgemm`` itself has no caller, as in the JAX package).  All
four route by semiring (``semiring_matmul.ops.route``): (+, ×) on the
TF32 tensor cores (``csrc/bsr_pairlist_tf32_sm90.cu``,
``csrc/semiring_tf32_sm90.cu``), the other five on the CUDA-core ring
(``csrc/bsr_pairlist.cu``, ``csrc/bsr_spgemm.cu``).  The pair lists
come from the planner (:func:`repro_torch.core.spgemm.plan_matmul`) and
MUST arrive grouped (sorted) by ``pair_c`` / ``pair_o``: the wrapper
turns the sorted output ids into run offsets, and the kernels give each
run (the fused reduce: each chunk of at most ``REDUCE_CHUNK`` pairs of a
run, :func:`reduce_chunks`) to one work item.  ``impl="auto"`` launches the kernel on CUDA tensors and
the plain version on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.semiring_matmul.ops import tf32_scratch
from .ref import (bsr_pairlist_ref, bsr_pairlist_reduce_ref,
                  bsr_spgemm_ref, bsr_spgemm_reduce_ref)

TILE = 128
# pairs of an output block's run that one work item of the fused pair-list
# reduce takes at most (a longer run is split over several blocks)
REDUCE_CHUNK = 16


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


def reduce_chunks(runs: torch.Tensor, n_pairs: int,
                  chunk: int = REDUCE_CHUNK):
    """Cut each run of ``runs`` (int32 [n+1] offsets) into chunks of at
    most ``chunk`` pairs, an empty run into one empty chunk.  Returns
    ``chunk_off`` (int32 [n+1], on the runs' device: output o's chunks are
    items ``chunk_off[o] .. chunk_off[o+1]-1``, chunk c of them its pairs
    ``runs[o] + c·chunk`` up to ``runs[o+1]``) and the most items any
    runs of ``n_pairs`` pairs can make, ``n + n_pairs // chunk`` (a bound
    the host knows without reading ``chunk_off`` back)."""
    n = runs.shape[0] - 1
    lens = runs[1:] - runs[:-1]
    per = torch.clamp((lens + chunk - 1) // chunk, min=1)
    off = torch.zeros(n + 1, dtype=torch.int32, device=runs.device)
    off[1:] = torch.cumsum(per, 0)
    return off, n + n_pairs // chunk


def _pair_lists_on(t: torch.Tensor, *pairs):
    """Pair lists given on the host (numpy, as the planner makes them) as
    int32 tensors on ``t``'s device; tensors pass through."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p, np.int32)).to(
        t.device) if isinstance(p, np.ndarray) else p for p in pairs)


def _check_pairlist(a_tiles, b_tiles, pair_a, pair_b, pair_x, n_out):
    """Validate what the kernel cannot: device, dtypes, shapes, and that
    every pair indexes a tile and the output ids are sorted within
    ``[0, n_out)`` — a bad index would read out of bounds.  Pair lists on
    the host (numpy) are checked there and uploaded, with no read-back;
    pair lists on the card are read back once."""
    host = isinstance(pair_a, np.ndarray)
    cuda_lib.check_cuda(a_tiles, b_tiles, *(() if host else
                                            (pair_a, pair_b, pair_x)))
    for name, t in (("a_tiles", a_tiles), ("b_tiles", b_tiles)):
        if t.dim() != 3 or t.shape[1:] != (TILE, TILE) \
                or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [n, {TILE}, {TILE}]; "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = pair_a.shape[0]
    for name, t in (("pair_a", pair_a), ("pair_b", pair_b),
                    ("pair_c/o", pair_x)):
        if t.shape != (n,) or (t.dtype != torch.int32 if not host else
                               t.dtype.kind not in "iu"):
            raise ValueError(f"{name} must be int32 [{n}]; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if n:
        bad = [(pair_a.min() < 0) | (pair_a.max() >= a_tiles.shape[0]),
               (pair_b.min() < 0) | (pair_b.max() >= b_tiles.shape[0]),
               (pair_x.min() < 0) | (pair_x.max() >= n_out),
               (pair_x[1:] < pair_x[:-1]).any()]
        bad = [bool(x) for x in bad] if host else torch.stack(bad).tolist()
        if any(bad):
            raise ValueError(
                "pair lists out of range or unsorted (pair_a, pair_b, "
                f"pair_c/o range, pair_c/o order): {bad}")
    pair_a, pair_b, pair_x = _pair_lists_on(a_tiles, pair_a, pair_b, pair_x)
    return (a_tiles.contiguous(), b_tiles.contiguous(),
            pair_a.contiguous(), pair_b.contiguous(), pair_x)


def bsr_pairlist_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_c, *,
                      n_c: int, sr: Semiring) -> torch.Tensor:
    """The kernel: packed C tiles ``[n_c, 128, 128]``; (+, ×) on the TF32
    route, the other five on the ring.  Checks its inputs
    (:func:`_check_pairlist`), then :func:`pairlist_launch`."""
    sid = cuda_lib.kernel_semiring_id(sr)
    a_tiles, b_tiles, pair_a, pair_b, pair_c = _check_pairlist(
        a_tiles, b_tiles, pair_a, pair_b, pair_c, n_c)
    return pairlist_launch(a_tiles, b_tiles, pair_a, pair_b, pair_c, n_c=n_c,
                           sid=sid)


def pairlist_launch(a_tiles, b_tiles, pair_a, pair_b, pair_c, *, n_c: int,
                    sid: int) -> torch.Tensor:
    """The launch alone, on inputs as :func:`_check_pairlist` returns them
    and the semiring's ``kernel_semiring_id``: no host read-back, so a
    device timing of it measures the kernel, not a host round trip."""
    runs = run_offsets(pair_c, n_c)
    c_tiles = torch.empty((n_c, TILE, TILE), dtype=torch.float32,
                          device=a_tiles.device)
    if n_c == 0:                  # no grid to launch: nothing to count
        return c_tiles
    ptrs = (a_tiles.data_ptr(), b_tiles.data_ptr(), pair_a.data_ptr(),
            pair_b.data_ptr(), runs.data_ptr(), c_tiles.data_ptr())
    stream = cuda_lib.stream_ptr(a_tiles)
    if sid == 0:
        cuda_lib.launch("bsr_pairlist_tf32", *ptrs, a_tiles.shape[0], n_c,
                        stream, counts=("bsr_pairlist", "bsr_pairlist_tf32"))
    else:
        cuda_lib.launch("bsr_pairlist", sid, *ptrs, n_c, stream)
    return c_tiles


def bsr_pairlist_reduce_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                             n_o: int, axis: int, sr: Semiring) -> torch.Tensor:
    """The kernel: per-output-block ⊕-folded vectors ``[n_o, 128]``; (+, ×)
    on the TF32 route, the other five on the ring.  Checks its inputs
    (:func:`_check_pairlist`), then :func:`pairlist_reduce_launch`."""
    sid = cuda_lib.kernel_semiring_id(sr)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    a_tiles, b_tiles, pair_a, pair_b, pair_o = _check_pairlist(
        a_tiles, b_tiles, pair_a, pair_b, pair_o, n_o)
    return pairlist_reduce_launch(a_tiles, b_tiles, pair_a, pair_b, pair_o,
                                  n_o=n_o, axis=axis, sid=sid)


def pairlist_reduce_launch(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                           n_o: int, axis: int, sid: int) -> torch.Tensor:
    """The reduce's launch alone (as :func:`pairlist_launch`).  Each chunk
    of a run (:func:`reduce_chunks`) writes a partial, which the same
    launch folds per output."""
    runs = run_offsets(pair_o, n_o)
    out = torch.empty((n_o, TILE), dtype=torch.float32, device=a_tiles.device)
    if n_o == 0:                  # no grid to launch: nothing to count
        return out
    chunk_off, max_items = reduce_chunks(runs, pair_a.shape[0])
    part = torch.empty((max_items, TILE), dtype=torch.float32,
                       device=a_tiles.device)
    ptrs = (a_tiles.data_ptr(), b_tiles.data_ptr(), pair_a.data_ptr(),
            pair_b.data_ptr(), runs.data_ptr(), chunk_off.data_ptr(),
            part.data_ptr(), out.data_ptr())
    shape = (n_o, max_items, REDUCE_CHUNK, axis, cuda_lib.stream_ptr(a_tiles))
    if sid == 0:
        cuda_lib.launch("bsr_pairlist_reduce_tf32", *ptrs, a_tiles.shape[0],
                        *shape, counts=("bsr_pairlist_reduce",
                                        "bsr_pairlist_reduce_tf32"))
    else:
        cuda_lib.launch("bsr_pairlist_reduce", sid, *ptrs, *shape)
    return out


def bsr_pairlist(a_tiles, b_tiles, pair_a, pair_b, pair_c, *, n_c: int,
                 semiring="plus_times", impl="auto") -> torch.Tensor:
    """Pair-list BSR contraction → packed C tiles ``[n_c, bm, bn]``.  The
    pair lists are int32 tensors on the tiles' device or host numpy arrays
    (the planner's), which the kernel route checks without a read-back."""
    sr = get_semiring(semiring)
    if cuda_lib.resolve_impl(impl, a_tiles) == "ref":
        return bsr_pairlist_ref(a_tiles, b_tiles, *_pair_lists_on(
            a_tiles, pair_a, pair_b, pair_c), n_c=n_c, semiring=sr)
    return bsr_pairlist_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_c,
                             n_c=n_c, sr=sr)


def bsr_pairlist_reduce(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                        n_o: int, axis: int, semiring="plus_times",
                        impl="auto") -> torch.Tensor:
    """Fused pair-list ``⊕-reduce(A ⊗.⊕ B, axis)`` → ``[n_o, 128]``
    per-output-block vectors (block-rows for axis=1, block-cols for 0).

    C tiles never exist: the kernel folds each run's products into one
    vector per output block.  The pair lists are taken as by
    :func:`bsr_pairlist`.
    """
    sr = get_semiring(semiring)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    if cuda_lib.resolve_impl(impl, a_tiles) == "ref":
        return bsr_pairlist_reduce_ref(a_tiles, b_tiles, *_pair_lists_on(
            a_tiles, pair_a, pair_b, pair_o), n_o=n_o, axis=axis,
            semiring=sr)
    return bsr_pairlist_reduce_cuda(a_tiles, b_tiles, pair_a, pair_b, pair_o,
                                    n_o=n_o, axis=axis, sr=sr)


def _check_masked(a, block_mask, b):
    """Validate the block-masked operands for the kernel: one card, fp32
    A [M,K] and B [K,N] with M, K, N multiples of 128, int32 mask
    [M/128, K/128]."""
    cuda_lib.check_cuda(a, block_mask, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("bsr_spgemm takes float32 operands")
    if block_mask.dtype != torch.int32:
        raise TypeError("bsr_spgemm takes an int32 block mask")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or m % TILE or k % TILE or n % TILE:
        raise ValueError(f"bsr_spgemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} are not {TILE}-multiples of one K")
    if tuple(block_mask.shape) != (m // TILE, k // TILE):
        raise ValueError(f"block mask {tuple(block_mask.shape)} is not "
                         f"{(m // TILE, k // TILE)}")
    return a.contiguous(), block_mask.contiguous(), b.contiguous(), m, k, n


def bsr_spgemm_cuda(a, block_mask, b, *, sr: Semiring) -> torch.Tensor:
    """The kernel: dense C [M, N] of the block-masked product; (+, ×) on
    the TF32 route (its store epilogue, walking each block-row's present k
    tiles), the other five on the ring."""
    sid = cuda_lib.kernel_semiring_id(sr)
    a, block_mask, b, m, k, n = _check_masked(a, block_mask, b)
    if m == 0 or n == 0:          # no grid to launch: nothing to count
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    if sid == 0:                  # (+, ×): the TF32 route
        if k == 0:                # the empty sum, with no product to run
            return torch.zeros((m, n), dtype=torch.float32, device=a.device)
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
        scratch, flags = tf32_scratch(m, n, k, a.device)
        cuda_lib.launch("bsr_spgemm_tf32", a.data_ptr(), block_mask.data_ptr(),
                        b.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
                        c.data_ptr(), m, n, k, cuda_lib.stream_ptr(a),
                        counts=("bsr_spgemm", "bsr_spgemm_tf32"))
        return c
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    cuda_lib.launch("bsr_spgemm", sid, a.data_ptr(), block_mask.data_ptr(),
                    b.data_ptr(), c.data_ptr(), m, n, k, cuda_lib.stream_ptr(a))
    return c


def bsr_spgemm_reduce_cuda(a, block_mask, b, *, axis: int,
                           sr: Semiring) -> torch.Tensor:
    """The kernel: per-output-tile partials ([N/128, M] for axis=1,
    [M/128, N] for axis=0), one per block; C is never stored."""
    sid = cuda_lib.kernel_semiring_id(sr)
    a, block_mask, b, m, k, n = _check_masked(a, block_mask, b)
    shape = (n // TILE, m) if axis == 1 else (m // TILE, n)
    if m == 0 or n == 0:          # no grid to launch: nothing to count
        return torch.empty(shape, dtype=torch.float32, device=a.device)
    if sid == 0:                  # (+, ×): the TF32 route
        if k == 0:                # the empty sum, with no product to run
            return torch.zeros(shape, dtype=torch.float32, device=a.device)
        part = torch.empty(shape, dtype=torch.float32, device=a.device)
        scratch, flags = tf32_scratch(m, n, k, a.device)
        cuda_lib.launch("bsr_spgemm_reduce_tf32", a.data_ptr(),
                        block_mask.data_ptr(), b.data_ptr(),
                        scratch.data_ptr(), flags.data_ptr(), part.data_ptr(),
                        m, n, k, axis, cuda_lib.stream_ptr(a),
                        counts=("bsr_spgemm_reduce", "bsr_spgemm_reduce_tf32"))
        return part
    part = torch.empty(shape, dtype=torch.float32, device=a.device)
    cuda_lib.launch("bsr_spgemm_reduce", sid, a.data_ptr(),
                    block_mask.data_ptr(), b.data_ptr(), part.data_ptr(),
                    m, n, k, axis, cuda_lib.stream_ptr(a))
    return part


def bsr_spgemm(a, block_mask, b, *, semiring="plus_times",
               impl="auto") -> torch.Tensor:
    """Block-masked dense A [M,K] ⊗.⊕ dense B [K,N] → dense C [M,N]; A's
    absent 128×128 tiles (``block_mask`` int32 [M/128, K/128] == 0) count
    as the semiring zero and are skipped."""
    sr = get_semiring(semiring)
    if cuda_lib.resolve_impl(impl, a) == "ref":
        return bsr_spgemm_ref(a, block_mask, b, semiring=sr)
    return bsr_spgemm_cuda(a, block_mask, b, sr=sr)


def bsr_spgemm_reduce(a, block_mask, b, *, axis: int,
                      semiring="plus_times", impl="auto") -> torch.Tensor:
    """Fused ``⊕-reduce(A ⊗.⊕ B, axis)`` over a block-masked dense A →
    vector ([M] for axis=1, [N] for axis=0).

    The kernel never stores C: each block folds its output tile to one
    ``[128]`` vector, and this wrapper ⊕-folds the per-tile partials.  The
    plain version materializes C and reduces it.
    """
    sr = get_semiring(semiring)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    if cuda_lib.resolve_impl(impl, a) == "ref":
        return bsr_spgemm_reduce_ref(a, block_mask, b, axis=axis,
                                     semiring=sr)
    part = bsr_spgemm_reduce_cuda(a, block_mask, b, axis=axis, sr=sr)
    return sr.add_reduce(part, axis=0)
