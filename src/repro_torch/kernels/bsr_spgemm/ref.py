"""Plain torch versions: the pair-list contractions (gather + batched
product per chunk + ⊕-scatter) and the mask-expanded semiring matmul with
its fused reduction."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import get_semiring
from repro_torch.kernels.semiring_matmul.ref import (TF32X3_C1, TF32X3_SLAB,
                                                     nonfinite_operands,
                                                     ring_nonfinite_operands)

# tile pairs contracted per chunk: the (+,×) bmm gathers chunk·(bm·bk +
# bk·bn + bm·bn) floats, the broadcast path adds a [chunk, bm, 32, bn] slab
# — both bounded to a few hundred MiB
_CHUNK_MATMUL = 256
_CHUNK_SLAB = 32


def combine_rows_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                  sr) -> torch.Tensor:
    """In place ``dst[idx[p]] ⊕= src[p]`` along axis 0 (every index valid;
    ``dst`` pre-filled with ``sr.zero``)."""
    idx = idx.to(torch.int64)
    if sr.add_kind == "sum":
        return dst.index_add_(0, idx, src)
    index = idx.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    return dst.scatter_reduce_(0, index, src,
                               "amax" if sr.add_kind == "max" else "amin",
                               include_self=True)


def bsr_spgemm_ref(a, block_mask, b, *, semiring="plus_times",
                   bm: int = 128, bk: int | None = None):
    """Block-masked dense A × dense B: A's absent tiles count as zero."""
    sr = get_semiring(semiring)
    if bk is None:
        bk = 128
    mask_full = torch.repeat_interleave(
        torch.repeat_interleave(block_mask != 0, bm, dim=0), bk, dim=1)
    a_masked = torch.where(mask_full, a.to(torch.float32),
                           torch.tensor(sr.zero, device=a.device))
    return sr.matmul_dense(a_masked, b.to(torch.float32))


def bsr_spgemm_tf32x3_error_bound(a, block_mask, b, *, bm: int = 128,
                                  bk: int = 128) -> torch.Tensor:
    """Element-wise bound on |C − A·B| (A's absent tiles zeroed) for the
    TF32 route of ``bsr_spgemm`` (``csrc/semiring_tf32_sm90.cu``): the
    dense route's bound (``semiring_matmul.ref.tf32x3_error_bound``) with
    K = bk × (the block-row's present k tiles), as the kernel walks only
    those slabs, ``(52·2^-22 + ceil(K/32)·2^-24)·(|A|·|B|)``, in fp64.  An
    empty block-row's bound is 0: its output is exactly 0."""
    keep = block_mask != 0
    full = torch.repeat_interleave(torch.repeat_interleave(keep, bm, dim=0),
                                   bk, dim=1)
    mag = torch.where(full, a.double().abs(), 0.0) @ b.double().abs()
    slabs = keep.sum(dim=1).double() * -(-bk // TF32X3_SLAB)
    scale = TF32X3_C1 * 2.0 ** -22 + slabs * 2.0 ** -24
    return torch.repeat_interleave(scale, bm)[:, None] * mag


def masked_nonfinite_operands(m: int, k: int, n: int, gen: torch.Generator,
                              device) -> tuple:
    """(a, block_mask, b) for the TF32 route's exact path under a block
    mask: ``nonfinite_operands`` (±inf, NaN-making and near-FLT_MAX entries
    in A's block-row 0 and in k tile 0 of B), a seeded mask keeping about
    half of A's tiles, and more entries in block-row 1: +inf, NaN and 2^100
    in an absent tile (the kernels skip it, the plain version zeroes it),
    NaN, +inf and 2^63 (above the split's 2^62) in a present one, each
    row's term of B's near-FLT_MAX entry kept finite as
    ``nonfinite_operands`` keeps it.  k tile 0 is present in every
    block-row, so no absent tile meets B's non-finite rows: there the
    plain version's 0·inf gives NaN, while the kernels skip the tile, as
    the Pallas kernel does.  m >= 256, k >= 384, both multiples of 128."""
    a, b = nonfinite_operands(m, k, n, gen, "cpu")
    mask = (torch.rand((m // 128, k // 128), generator=gen) < 0.5).int()
    mask[:, 0], mask[1, 1], mask[1, 2] = 1, 0, 1
    inf, nan = float("inf"), float("nan")
    a[133, 137], a[134, 138], a[135, 139] = inf, nan, 2.0 ** 100    # absent
    a[148, 259], a[149, 260], a[150, 261] = nan, inf, 2.0 ** 63     # present
    a[148:151, 70] = 0.25
    return a.to(device), mask.to(device), b.to(device)


def masked_ring_nonfinite_operands(m: int, k: int, n: int,
                                   gen: torch.Generator, device) -> tuple:
    """(a, block_mask, b) for the ring semirings under a block mask:
    ``ring_nonfinite_operands`` (NaN and opposite infinities, B's in k tile
    0), a seeded mask keeping about half of A's tiles with k tile 0 present
    in every block-row, and NaN, +inf and −inf in an absent tile of A
    (block (m/128 - 1, 1)), which the kernels skip and the plain version
    replaces by the semiring zero.  No absent tile meets B's non-finite
    rows: there the plain version's zero ⊗ ±inf or NaN would give NaN where
    the kernels, like the Pallas kernel, skip the tile.  m >= 128, k >= 256,
    both multiples of 128; n >= 34."""
    a, b = ring_nonfinite_operands(m, k, n, gen, "cpu")
    mask = (torch.rand((m // 128, k // 128), generator=gen) < 0.5).int()
    mask[:, 0], mask[-1, 1] = 1, 0
    r = m - 128
    a[r + 5, 133], a[r + 6, 140], a[r + 7, 150] = (float("nan"), float("inf"),
                                                   -float("inf"))
    return a.to(device), mask.to(device), b.to(device)


def bsr_spgemm_reduce_ref(a, block_mask, b, *, axis: int,
                          semiring="plus_times",
                          bm: int = 128, bk: int | None = None):
    """Unfused version: materialize C, then ⊕-reduce it along ``axis``."""
    sr = get_semiring(semiring)
    c = bsr_spgemm_ref(a, block_mask, b, semiring=sr, bm=bm, bk=bk)
    return sr.add_reduce(c, axis=axis)


def chunk_products(a_part: torch.Tensor, b_part: torch.Tensor,
                   sr) -> torch.Tensor:
    """Batched tile contraction [c,bm,bk] ⊗.⊕ [c,bk,bn] → [c,bm,bn]."""
    if sr.mxu:
        return torch.bmm(a_part, b_part)
    bk = a_part.shape[2]
    out = torch.full((a_part.shape[0], a_part.shape[1], b_part.shape[2]),
                     sr.zero, dtype=torch.float32, device=a_part.device)
    for k0 in range(0, bk, 32):  # k-slabs keep the broadcast in budget
        prod = sr.mul(a_part[:, :, k0:k0 + 32, None],
                      b_part[:, None, k0:k0 + 32, :])
        out = sr.add(out, sr.add_reduce(prod, axis=2))
    return out


def bsr_pairlist_ref(a_tiles, b_tiles, pair_a, pair_b, pair_c, *, n_c: int,
                     semiring="plus_times") -> torch.Tensor:
    """Pair-list contraction → packed C tiles ``[n_c, bm, bn]``."""
    sr = get_semiring(semiring)
    bm, bn = a_tiles.shape[1], b_tiles.shape[2]
    c_tiles = torch.full((n_c, bm, bn), sr.zero, dtype=torch.float32,
                         device=a_tiles.device)
    chunk = _CHUNK_MATMUL if sr.mxu else _CHUNK_SLAB
    pa, pb, pc = (p.to(torch.int64) for p in (pair_a, pair_b, pair_c))
    for p0 in range(0, pa.shape[0], chunk):
        parts = chunk_products(a_tiles[pa[p0:p0 + chunk]],
                               b_tiles[pb[p0:p0 + chunk]], sr)
        combine_rows_(c_tiles, pc[p0:p0 + chunk], parts, sr)
    return c_tiles


def bsr_pairlist_reduce_ref(a_tiles, b_tiles, pair_a, pair_b, pair_o, *,
                            n_o: int, axis: int,
                            semiring="plus_times") -> torch.Tensor:
    """Pair-list fused reduce → per-output-block vectors ``[n_o, 128]``."""
    sr = get_semiring(semiring)
    width = a_tiles.shape[1] if axis == 1 else b_tiles.shape[2]
    out = torch.full((n_o, width), sr.zero, dtype=torch.float32,
                     device=a_tiles.device)
    chunk = _CHUNK_MATMUL if sr.mxu else _CHUNK_SLAB
    pa, pb, po = (p.to(torch.int64) for p in (pair_a, pair_b, pair_o))
    for p0 in range(0, pa.shape[0], chunk):
        parts = chunk_products(a_tiles[pa[p0:p0 + chunk]],
                               b_tiles[pb[p0:p0 + chunk]], sr)
        pvec = sr.add_reduce(parts, axis=2 if axis == 1 else 1)
        combine_rows_(out, po[p0:p0 + chunk], pvec, sr)
    return out
