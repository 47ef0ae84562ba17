"""Plain torch versions: the pair-list contractions (gather + batched
product per chunk + ⊕-scatter) and the mask-expanded semiring matmul with
its fused reduction."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import get_semiring

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
