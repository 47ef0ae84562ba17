"""Graphulo-style sparse matmul planner: the one engine behind ``⊗.⊕``.

"D4M: Bringing Associative Arrays to Database Engines" (Graphulo) showed
that associative-array multiplication scales by pushing the semiring
contraction — and the reduction that usually follows it — down to the
sparse storage layer instead of materializing dense intermediates.  This
module is that pushdown for the device layer: it plans every
``A ⊗.⊕ B`` on the **host** (block structure, strategy choice, product
counts — all cheap numpy over the operands' rank triples) and executes it
on the operands' device under one of three strategies:

``dense``
    Densify both operands onto 128-aligned adjacency tiles and contract
    with the semiring-matmul kernel (:mod:`repro_torch.kernels.semiring_matmul`).
    Peak memory O(M·K + K·N + M·N) — unbeatable for small or genuinely
    dense operands, hopeless at scale.
``bsr``
    Block-tiled sparse path: pack only the **present** 128×128 tiles of
    each operand, contract the planned tile-pair list with the pair-list
    kernel (:mod:`repro_torch.kernels.bsr_spgemm`: one CUDA block per
    output-tile run, the run's ⊕ kept in registers and each C tile written
    once), and emit the result COO **directly from the tiles** — no
    |rowspace|×|colspace| dense product and no sort ever exist.  Peak memory
    is bounded by the present tiles plus the output COO, which is sized by
    :func:`estimate_out_nnz` rather than the raw product count.
``coo``
    Expand-join on raw rank triples (:func:`repro_torch.core.coo.expand_join_coo`
    + one canonical merge); the right choice when operands are tiny.

Strategy choice (``impl="auto"``) compares modeled footprints::

    dense_cost = Mp·Kp + Kp·Np + Mp·Np          (padded dense operands + C)
    bsr_cost   = (nA + nB + nPairs + 2·nC) · T  (packed tiles, T = 128²)

and picks ``bsr`` iff it is strictly cheaper — i.e. exactly when the tile
occupancy is low enough that skipping empty tiles beats the dense sweep.
``impl=`` overrides the choice per call.  ``auto`` never picks ``coo``.

The fused epilogues (:func:`matmul_reduce`) compute row/column
⊕-reductions of ``A ⊗.⊕ B`` — the ``sqin``/``sqout``/degree family —
without materializing C: the bsr strategy folds tile products straight
into a vector of length M (or N) inside the pair-list reduce kernel, and
the dense strategy runs the block-masked fused reduce kernel
(``bsr_spgemm_reduce``), which skips A's absent tiles and folds each
output tile to a vector.  Planning is host-side and eager by design: it
reads the operands' valid rank codes back to the host once per product.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .coo import SENT, dedup_sorted_coo, expand_join_coo
from .semiring import PLUS_TIMES, Semiring, get_semiring, scatter_combine

__all__ = ["MatmulPlan", "plan_matmul", "matmul", "matmul_reduce",
           "bsr_matmul_coo", "pack_tiles", "estimate_out_nnz", "reduce_pairs",
           "tiles_to_coo", "stage_timing", "STAGE_MS", "TILE"]

TILE = 128  # block edge: bm = bk = bn = 128

# Wall-clock milliseconds per stage of ``matmul`` / ``matmul_reduce`` (and
# of the device ingest merge, ``repro_torch.ingest``), summed over the
# calls run inside :func:`stage_timing`.  Off by default: a timed stage
# ends with a device sync, so the stages add up to the call's time, but
# host and device work no longer overlap.
STAGE_MS: Dict[str, float] = {}
_STAGE_TIMING = False


@contextlib.contextmanager
def stage_timing():
    """Time the stages of every product run in the block into
    :data:`STAGE_MS` (cleared on entry), which it yields."""
    global _STAGE_TIMING
    STAGE_MS.clear()
    _STAGE_TIMING = True
    try:
        yield STAGE_MS
    finally:
        _STAGE_TIMING = False


@contextlib.contextmanager
def _stage(name: str, device):
    if not _STAGE_TIMING:
        yield
        return
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    STAGE_MS[name] = STAGE_MS.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class MatmulPlan:
    """Host-side execution plan for one ``A ⊗.⊕ B``.

    Block structure is expressed per *valid entry* (tile id + intra-tile
    coords, the scatter targets for tile packing) and per *tile pair*
    (which A tile meets which B tile, accumulating into which C tile).
    The pair lists are **grouped by ``pair_c``** (sorted ascending) — the
    pair-list kernel gives each C tile's contiguous run of pairs to one
    block, so no two blocks write the same tile.  ``products`` is the
    exact scalar product count — an upper bound on nnz(C); the default
    output sizing tightens it via :func:`estimate_out_nnz`.
    """

    impl: str                    # chosen strategy: "dense" | "bsr"
    m: int
    k: int
    n: int
    # A entries → packed tiles
    a_tile_of: np.ndarray
    a_lr: np.ndarray
    a_lc: np.ndarray
    a_blocks: np.ndarray         # [nA, 2] (block-row, block-k)
    # B entries → packed tiles
    b_tile_of: np.ndarray
    b_lr: np.ndarray
    b_lc: np.ndarray
    b_blocks: np.ndarray         # [nB, 2] (block-k, block-col)
    # tile-pair contraction list
    pair_a: np.ndarray
    pair_b: np.ndarray
    pair_c: np.ndarray
    c_blocks: np.ndarray         # [nC, 2] (block-row, block-col)
    products: int
    dense_cost: int
    bsr_cost: int


def pad_to_cap(r: torch.Tensor, c: torch.Tensor, v: torch.Tensor,
               cap: int, zero: float):
    """Slice canonical triples to ``cap`` and sentinel-pad the tail."""
    r, c, v = r[:cap], c[:cap], v[:cap]
    pad = cap - r.shape[0]
    if pad > 0:
        r = torch.cat([r, r.new_full((pad,), SENT)])
        c = torch.cat([c, c.new_full((pad,), SENT)])
        v = torch.cat([v, v.new_full((pad,), zero)])
    return r, c, v


def _densify_aligned(a, b, sr: Semiring):
    """Dense-strategy prologue: both adjs on 128-aligned tiles, K matched."""
    da = a.to_dense_adj(zero=sr.zero)
    db = b.to_dense_adj(zero=sr.zero)
    kk = max(da.shape[1], db.shape[0])
    da = torch.nn.functional.pad(da, (0, kk - da.shape[1]), value=sr.zero)
    db = torch.nn.functional.pad(db, (0, 0, 0, kk - db.shape[0]),
                                 value=sr.zero)
    return da, db


def _exact_products(a_k: np.ndarray, b_k: np.ndarray, k: int) -> int:
    """Exact scalar product count: ⟨per-k nnz of A, per-k nnz of B⟩."""
    if k == 0 or len(a_k) == 0 or len(b_k) == 0:
        return 0
    return int(np.bincount(a_k, minlength=k).astype(np.int64)
               @ np.bincount(b_k, minlength=k).astype(np.int64))


def _entry_blocks(rows: np.ndarray, cols: np.ndarray, bm: int, bk: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-entry tile assignment: (tile_of, local_r, local_c, blocks[nT, 2])."""
    bi = rows // bm
    bj = cols // bk
    codes = bi.astype(np.int64) * (2 ** 31) + bj
    uniq, tile_of = np.unique(codes, return_inverse=True)
    blocks = np.stack([(uniq // (2 ** 31)).astype(np.int32),
                       (uniq % (2 ** 31)).astype(np.int32)], axis=1)
    return tile_of.astype(np.int32), (rows % bm).astype(np.int32), \
        (cols % bk).astype(np.int32), blocks


def plan_matmul(a_rows: np.ndarray, a_cols: np.ndarray,
                b_rows: np.ndarray, b_cols: np.ndarray,
                m: int, k: int, n: int, *, impl: str = "auto",
                bm: int = TILE, bk: int = TILE, bn: int = TILE) -> MatmulPlan:
    """Plan ``C[i,j] = ⊕_k A[i,k] ⊗ B[k,j]`` over *valid* host rank triples.

    ``a_rows/a_cols`` are A's (row, contraction) codes, ``b_rows/b_cols``
    B's (contraction, col) codes — valid entries only, no sentinels.  See
    the module docstring for the strategy heuristic.
    """
    a_tile_of, a_lr, a_lc, a_blocks = _entry_blocks(a_rows, a_cols, bm, bk)
    b_tile_of, b_lr, b_lc, b_blocks = _entry_blocks(b_rows, b_cols, bk, bn)

    # tile-pair join on the contraction block: B blocks are sorted by
    # (block-k, block-col) already (np.unique), A blocks by (block-row,
    # block-k) — sort A's k column for the merge
    a_k = a_blocks[:, 1]
    b_k = b_blocks[:, 0]
    a_ord = np.argsort(a_k, kind="stable")
    lo = np.searchsorted(b_k, a_k[a_ord], side="left")
    hi = np.searchsorted(b_k, a_k[a_ord], side="right")
    counts = hi - lo
    total = int(counts.sum())
    pair_a = np.repeat(a_ord, counts).astype(np.int32)
    run_base = np.repeat(np.cumsum(counts) - counts, counts)
    pair_b = (np.repeat(lo, counts)
              + (np.arange(total) - run_base)).astype(np.int32)
    c_codes = (a_blocks[pair_a, 0].astype(np.int64) * (2 ** 31)
               + b_blocks[pair_b, 1])
    c_uniq, pair_c = np.unique(c_codes, return_inverse=True)
    c_blocks = np.stack([(c_uniq // (2 ** 31)).astype(np.int32),
                         (c_uniq % (2 ** 31)).astype(np.int32)], axis=1)
    # group pairs by output tile (sorted pair_c): the pair-list kernel runs
    # one block per C tile's contiguous run of pairs and writes the tile
    # exactly once — see kernels/bsr_spgemm
    order = np.argsort(pair_c, kind="stable")
    pair_a, pair_b, pair_c = pair_a[order], pair_b[order], pair_c[order]

    products = _exact_products(a_cols, b_rows, k)

    t = bm * bk
    dense_cost = (_round_up(max(m, 1), bm) * _round_up(max(k, 1), bk)
                  + _round_up(max(k, 1), bk) * _round_up(max(n, 1), bn)
                  + _round_up(max(m, 1), bm) * _round_up(max(n, 1), bn))
    bsr_cost = (len(a_blocks) + len(b_blocks) + total + 2 * len(c_blocks)) * t
    if impl == "auto":
        impl = "bsr" if bsr_cost < dense_cost else "dense"
    return MatmulPlan(impl=impl, m=m, k=k, n=n,
                      a_tile_of=a_tile_of, a_lr=a_lr, a_lc=a_lc,
                      a_blocks=a_blocks,
                      b_tile_of=b_tile_of, b_lr=b_lr, b_lc=b_lc,
                      b_blocks=b_blocks,
                      pair_a=pair_a, pair_b=pair_b,
                      pair_c=pair_c.astype(np.int32), c_blocks=c_blocks,
                      products=products,
                      dense_cost=dense_cost, bsr_cost=bsr_cost)


# distinct-(i,j) sketch sizing: a 1<<20-bin bitmap costs 1 MiB host memory;
# candidate enumeration is skipped past the budget (the cheap bounds win)
_SKETCH_BINS = 1 << 20
_SKETCH_BUDGET = 1 << 22
_EXACT_BITSET_MAX = 1 << 22


def estimate_out_nnz(plan: MatmulPlan, *, budget: int = _SKETCH_BUDGET,
                     bins: int = _SKETCH_BINS) -> int:
    """Upper-bound estimate of ``nnz(C)`` — what ``out_capacity`` defaults to.

    The exact product count over-sizes hub-heavy outputs by orders of
    magnitude (every product through a hub row lands on the same few
    cells).  This estimator tightens it with three *provable* bounds plus
    one sketch:

    1. ``m·n`` and ``products`` (the old default);
    2. present C tiles × tile area;
    3. ``Σ_pairs |distinct rows(A tile)| · |distinct cols(B tile)|`` — every
       nonzero of C lies in some pair's candidate rectangle;
    4. when the candidate enumeration fits ``budget``: the exact distinct
       candidate count via a bitset (small keyspaces — still a provable
       bound), else a linear-counting hash sketch over the candidate
       ``(i, j)`` codes, inflated 1.25× for collision slack.

    Only (4)'s hashed variant can in principle under-estimate; a saturated
    sketch (≥98% bins set) warns and falls back to the provable bounds —
    and the downstream overflow warning in :func:`bsr_matmul_coo` remains
    the safety net.
    """
    if len(plan.pair_a) == 0:
        return 0
    m, n = max(plan.m, 1), max(plan.n, 1)
    bound = min(plan.products, m * n,
                len(plan.c_blocks) * TILE * TILE)
    # per-tile distinct local rows (A) / local cols (B)
    a_codes = np.unique(plan.a_tile_of.astype(np.int64) * TILE + plan.a_lr)
    b_codes = np.unique(plan.b_tile_of.astype(np.int64) * TILE + plan.b_lc)
    a_starts = np.searchsorted(a_codes // TILE,
                               np.arange(len(plan.a_blocks) + 1))
    b_starts = np.searchsorted(b_codes // TILE,
                               np.arange(len(plan.b_blocks) + 1))
    pa, pb = plan.pair_a, plan.pair_b
    n_rows = a_starts[pa + 1] - a_starts[pa]
    n_cols = b_starts[pb + 1] - b_starts[pb]
    cross = int((n_rows.astype(np.int64) * n_cols).sum())
    bound = min(bound, cross)
    if cross > budget or bound <= 4096:
        return bound

    # enumerate candidate (i, j) codes pair by pair into a bitmap
    hashed = m * n > _EXACT_BITSET_MAX
    bits = np.zeros(bins if hashed else m * n, dtype=bool)
    a_loc = (a_codes % TILE).astype(np.int64)
    b_loc = (b_codes % TILE).astype(np.int64)
    for p in range(len(pa)):
        rows = (a_loc[a_starts[pa[p]]:a_starts[pa[p] + 1]]
                + int(plan.a_blocks[pa[p], 0]) * TILE)
        cols = (b_loc[b_starts[pb[p]]:b_starts[pb[p] + 1]]
                + int(plan.b_blocks[pb[p], 1]) * TILE)
        codes = rows[:, None] * n + cols[None, :]
        if hashed:
            codes = (codes.astype(np.uint64)
                     * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(bins)
        bits[codes.ravel()] = True
    hit = int(bits.sum())
    if not hashed:
        return min(bound, hit)  # exact distinct candidates: provable bound
    empty = bits.size - hit
    if empty < bits.size * 0.02:
        warnings.warn(
            f"estimate_out_nnz: distinct-pair sketch saturated "
            f"({hit}/{bits.size} bins); falling back to the exact product "
            f"count bound", RuntimeWarning, stacklevel=2)
        return bound
    est = bits.size * np.log(bits.size / empty)  # linear counting
    return min(bound, int(est * 1.25) + 64)


def _upload(x: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                         dtype=dtype)


def pack_tiles(vals: torch.Tensor, tile_of: np.ndarray, lr: np.ndarray,
               lc: np.ndarray, n_tiles: int, br: int, bc: int,
               zero: float) -> torch.Tensor:
    """Scatter valid COO values into packed dense tiles [n_tiles, br, bc]."""
    dev = vals.device
    tiles = torch.full((max(n_tiles, 1), br, bc), zero, dtype=torch.float32,
                       device=dev)
    if len(tile_of) == 0:
        return tiles
    tiles[_upload(tile_of, dev), _upload(lr, dev), _upload(lc, dev)] = \
        vals.to(torch.float32)
    return tiles


def _warn_overflow(true_nnz: int, capacity: int, what: str) -> None:
    warnings.warn(
        f"{what}: result has {true_nnz} entries but capacity {capacity}; "
        f"{true_nnz - capacity} entries were dropped — pass a larger "
        f"out_capacity", RuntimeWarning, stacklevel=3)


def tiles_to_coo(c_tiles: torch.Tensor, c_blocks: np.ndarray, m: int, n: int,
                 zero: float, out_capacity: int):
    """Packed C tiles → the first ``out_capacity`` canonical COO entries.

    ``c_blocks`` is sorted by (block-row, block-col), so each block-row's
    tiles are one contiguous run, and the canonical (row, col) order of a
    run's cells is its ``[t, bm, bn]`` slab read as ``[bm, t, bn]``.  One
    scatter through that permutation lays every cell at its canonical
    position; the valid ones are then read out in order — no sort.
    Returns ``(rows, cols, vals, true_nnz)`` with ``min(true_nnz,
    out_capacity)`` entries.
    """
    n_c, bm, bn = c_tiles.shape
    dev = c_tiles.device
    bi_h = c_blocks[:, 0].astype(np.int64)
    first = np.searchsorted(bi_h, bi_h, side="left")      # run start tile
    count = np.searchsorted(bi_h, bi_h, side="right") - first
    p = np.arange(n_c, dtype=np.int64)
    base = _upload(first * bm * bn + (p - first) * bn, dev)
    stride = _upload(count * bn, dev)
    lr = torch.arange(bm, device=dev)
    lc = torch.arange(bn, device=dev)
    dest = (base[:, None, None] + lr[None, :, None] * stride[:, None, None]
            + lc[None, None, :]).reshape(-1)

    bi = _upload(bi_h, dev)
    bj = _upload(c_blocks[:, 1], dev)
    valid = ((c_tiles != zero)
             & (bi[:, None, None] * bm + lr[None, :, None] < m)
             & (bj[:, None, None] * bn + lc[None, None, :] < n)).reshape(-1)
    total = n_c * bm * bn
    canon_valid = torch.zeros(total, dtype=torch.bool, device=dev)
    canon_valid[dest] = valid
    canon_vals = torch.empty(total, dtype=torch.float32, device=dev)
    canon_vals[dest] = c_tiles.reshape(-1)
    del dest, valid
    q = torch.nonzero(canon_valid).squeeze(1)
    true_nnz = q.shape[0]
    q = q[:out_capacity]
    v = canon_vals[q]

    # decode canonical positions: run → (local row, tile in run, local col)
    heads = np.flatnonzero(np.r_[True, bi_h[1:] != bi_h[:-1]])
    run_start = _upload(heads * bm * bn, dev)
    g = torch.searchsorted(run_start, q, right=True) - 1
    width = _upload(count[heads] * bn, dev)[g]
    w = q - run_start[g]
    rem = w % width
    rows = _upload(bi_h[heads], dev)[g] * bm + w // width
    cols = bj[_upload(heads, dev)[g] + rem // bn] * bn + rem % bn
    return rows.to(torch.int32), cols.to(torch.int32), v, true_nnz


def bsr_matmul_coo(plan: MatmulPlan, a_vals: torch.Tensor,
                   b_vals: torch.Tensor, sr: Semiring, out_capacity: int, *,
                   kernel_impl: str = "auto",
                   bm: int = TILE, bk: int = TILE, bn: int = TILE):
    """Execute the BSR strategy: packed tiles in, canonical COO out.

    The pair-list contraction dispatches through
    :func:`repro_torch.kernels.bsr_spgemm.ops.bsr_pairlist` — the CUDA
    kernel on CUDA tensors, its plain torch version on CPU tensors
    (``kernel_impl`` forwards to that dispatch).

    Returns ``(rows, cols, vals, nnz, overflowed)``; the extraction runs
    over the **present C tiles only** — never over |rowspace|×|colspace| —
    so peak memory is tiles + the output COO.
    """
    dev = a_vals.device
    if len(plan.pair_a) == 0:
        rows = torch.full((out_capacity,), SENT, dtype=torch.int32,
                          device=dev)
        return rows, rows.clone(), torch.full(
            (out_capacity,), sr.zero, dtype=torch.float32, device=dev), \
            torch.zeros((), dtype=torch.int32, device=dev), False

    from repro_torch.kernels.bsr_spgemm.ops import bsr_pairlist

    with _stage("pack_tiles", dev):
        a_tiles = pack_tiles(a_vals, plan.a_tile_of, plan.a_lr, plan.a_lc,
                             len(plan.a_blocks), bm, bk, sr.zero)
        b_tiles = pack_tiles(b_vals, plan.b_tile_of, plan.b_lr, plan.b_lc,
                             len(plan.b_blocks), bk, bn, sr.zero)
    n_c = len(plan.c_blocks)
    with _stage("kernel", dev):   # with the wrapper's checks
        c_tiles = bsr_pairlist(
            a_tiles, b_tiles, _upload(plan.pair_a, dev, torch.int32),
            _upload(plan.pair_b, dev, torch.int32),
            _upload(plan.pair_c, dev, torch.int32),
            n_c=n_c, semiring=sr, impl=kernel_impl)
    del a_tiles, b_tiles
    with _stage("tiles_to_coo", dev):
        r, c, v, true_nnz = tiles_to_coo(c_tiles, plan.c_blocks, plan.m,
                                         plan.n, sr.zero, out_capacity)
    overflowed = true_nnz > out_capacity
    if overflowed:
        _warn_overflow(true_nnz, out_capacity, "bsr_matmul_coo")
    r, c, v = pad_to_cap(r, c, v, out_capacity, sr.zero)
    nnz = torch.tensor(min(true_nnz, out_capacity), dtype=torch.int32,
                       device=dev)
    return r, c, v, nnz, overflowed


def _contraction_aligned(a, b, sr: Semiring):
    """Shared prologue: logical() strings, align the contraction keyspace."""
    a = a.logical() if not a.numeric else a
    b = b.logical() if not b.numeric else b
    ks, a_map, b_map = a.col_space.union(b.row_space)
    a = a.reranked(a.row_space, ks,
                   np.arange(len(a.row_space), dtype=np.int32), a_map)
    b = b.reranked(ks, b.col_space, b_map,
                   np.arange(len(b.col_space), dtype=np.int32))
    return a, b, ks


def _valid_host(t) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host copies of the valid (row, col) rank codes of an AssocTensor
    (on a card: one synchronising read of ``nnz`` and two copies)."""
    nnz = int(t.nnz)
    return (t.rows[:nnz].cpu().numpy().astype(np.int64),
            t.cols[:nnz].cpu().numpy().astype(np.int64), nnz)


def _apply_keep(t, rows: np.ndarray, cols: np.ndarray, nnz: int,
                keep: Optional[np.ndarray]):
    """Slice an operand's entry lists by a host keep mask (selector fusion).

    ``keep`` is a bool array over the ``nnz`` valid entries (None ⇒ all).
    Returns ``(rows, cols, vals)`` with the host code arrays subset and the
    device values gathered at the kept positions — a *list slice*, never a
    canonicalized sliced array: the subset of a sorted canonical COO is
    itself sorted canonical, so no compaction ever runs.
    """
    if keep is None:
        return rows, cols, t.vals[:nnz]
    if len(keep) != nnz:
        raise ValueError(f"keep mask of length {len(keep)} for operand "
                         f"with {nnz} valid entries")
    idx = np.flatnonzero(np.asarray(keep, bool))
    return rows[idx], cols[idx], t.vals[_upload(idx, t.device)]


def _pad_triples(rows: np.ndarray, cols: np.ndarray, vals: torch.Tensor,
                 cap: int, zero: float):
    """Kept host codes + device vals → sentinel-padded device COO triples
    (sorted by construction) for the expand-join path."""
    dev = vals.device
    return pad_to_cap(_upload(rows, dev, torch.int32),
                      _upload(cols, dev, torch.int32),
                      vals.to(torch.float32), cap, zero)


def _scatter_dense(rows: np.ndarray, cols: np.ndarray, vals: torch.Tensor,
                   nr: int, nc: int, zero: float,
                   pad_to: int = TILE) -> torch.Tensor:
    """Densify kept triples onto a 128-aligned adj (keep-aware twin of
    ``AssocTensor.to_dense_adj``)."""
    dev = vals.device
    nrp = _round_up(max(nr, 1), pad_to)
    ncp = _round_up(max(nc, 1), pad_to)
    dense = torch.full((nrp, ncp), zero, dtype=torch.float32, device=dev)
    if len(rows) == 0:
        return dense
    dense[_upload(rows, dev), _upload(cols, dev)] = vals.to(torch.float32)
    return dense


def reduce_pairs(plan: MatmulPlan, axis: int):
    """Regroup the plan's pairs by output block — block-row for ``axis=1``,
    block-col for ``axis=0`` — for the fused reduce.  Returns ``(pair_a,
    pair_b, pair_o, o_uniq)``: pairs sorted by their output-block index
    ``pair_o`` into the ascending unique block ids ``o_uniq``."""
    blk = (plan.a_blocks[plan.pair_a, 0] if axis == 1
           else plan.b_blocks[plan.pair_b, 1])
    order = np.argsort(blk, kind="stable")
    o_uniq, pair_o = np.unique(blk[order], return_inverse=True)
    return plan.pair_a[order], plan.pair_b[order], pair_o, o_uniq


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "dense", "bsr", "coo"):
        raise ValueError(f"unknown matmul impl {impl!r}; "
                         f"expected auto/dense/bsr/coo")


def matmul(a, b, semiring=PLUS_TIMES, *, impl: str = "auto",
           out_capacity: Optional[int] = None, use_kernel: bool = True,
           kernel_impl: str = "auto",
           a_keep: Optional[np.ndarray] = None,
           b_keep: Optional[np.ndarray] = None):
    """Array multiplication ``A ⊗.⊕ B`` for device AssocTensors, planned.

    ``impl``: ``"auto"`` (heuristic), ``"dense"``, ``"bsr"`` or ``"coo"``
    (see module docstring).  ``use_kernel=False`` keeps the dense strategy
    on the plain torch contraction (test oracle).  ``kernel_impl``
    forwards to the kernel dispatch (``"auto"`` follows the tensors'
    device, ``"cuda"`` or ``"ref"`` force one).  When no ``out_capacity``
    is given, the BSR strategy sizes the output COO with
    :func:`estimate_out_nnz` instead of the exact product count.

    ``a_keep``/``b_keep`` are host bool masks over the operands' valid
    entries (the compiled form of a deferred selection, see
    :mod:`repro_torch.core.plan`): the plan's entry/tile lists are sliced
    and the values gathered once, so ``A[sel] @ B[sel]`` runs without ever
    building either slice as an array.
    """
    from .assoc_tensor import AssocTensor

    _check_impl(impl)
    sr = get_semiring(semiring)
    with _stage("align", a.device):
        a, b, ks = _contraction_aligned(a, b, sr)
    m, k, n = len(a.row_space), len(ks), len(b.col_space)
    with _stage("valid_host", a.device):
        ra, ca, na = _valid_host(a)
        rb, cb, nb = _valid_host(b)
    ra, ca, a_vals = _apply_keep(a, ra, ca, na, a_keep)
    rb, cb, b_vals = _apply_keep(b, rb, cb, nb, b_keep)
    filtered = a_keep is not None or b_keep is not None

    def _cap(products: int) -> int:
        return out_capacity or max(8, _round_up(
            min(products, max(m, 1) * max(n, 1)) or 8, 8))

    if impl == "coo":
        # no tile planning needed: the expansion size is the exact product
        # count, one bincount dot over the contraction codes
        products = _exact_products(ca, rb, k)
        cap = _cap(products)
        expand = max(8, _round_up(max(products, 1), 8))
        ar, ac, av = ((a.rows, a.cols, a.vals) if a_keep is None
                      else _pad_triples(ra, ca, a_vals, a.capacity, sr.zero))
        br, bc, bv = ((b.rows, b.cols, b.vals) if b_keep is None
                      else _pad_triples(rb, cb, b_vals, b.capacity, sr.zero))
        pr, pc, pv, _ = expand_join_coo(ar, ac, av, br, bc, bv,
                                        sr.mul, zero=sr.zero, expand=expand)
        r, c, v, nnz = dedup_sorted_coo(pr, pc, pv, sr.add, zero=sr.zero)
        true_nnz = int(nnz)
        overflowed = true_nnz > cap
        if overflowed:
            _warn_overflow(true_nnz, cap, "matmul[coo]")
        r, c, v = pad_to_cap(r, c, v, cap, sr.zero)
        out = AssocTensor(r, c, v, nnz.clamp(max=cap),
                          a.row_space, b.col_space, None)
        out.overflow = overflowed
        return out

    def _dense(cap: int) -> "AssocTensor":
        with _stage("densify", a.device):
            if filtered:
                da = _scatter_dense(ra, ca, a_vals, m, k, sr.zero)
                db = _scatter_dense(rb, cb, b_vals, k, n, sr.zero)
            else:
                da, db = _densify_aligned(a, b, sr)
        with _stage("kernel", a.device):
            if use_kernel:
                from repro_torch.kernels.semiring_matmul.ops import \
                    semiring_matmul
                dc = semiring_matmul(da, db, semiring=sr, impl=kernel_impl)
            else:
                dc = sr.matmul_dense(da, db)
        with _stage("from_dense_adj", a.device):
            return AssocTensor.from_dense_adj(dc, a.row_space, b.col_space,
                                              cap, zero=sr.zero)

    if impl == "dense":
        # explicit dense: no tile-pair planning needed, only the product
        # count for the default capacity
        return _dense(_cap(_exact_products(ca, rb, k)))

    with _stage("plan", a.device):
        plan = plan_matmul(ra, ca, rb, cb, m, k, n, impl=impl)
    if plan.impl == "dense":
        return _dense(_cap(plan.products))

    with _stage("estimate_out_nnz", a.device):
        cap = out_capacity or max(8, _round_up(
            max(estimate_out_nnz(plan), 1), 8))
    r, c, v, nnz, overflowed = bsr_matmul_coo(plan, a_vals, b_vals, sr, cap,
                                              kernel_impl=kernel_impl)
    out = AssocTensor(r, c, v, nnz, a.row_space, b.col_space, None)
    out.overflow = overflowed
    return out


def matmul_reduce(a, b, axis: int, semiring=PLUS_TIMES, *,
                  impl: str = "auto", kernel_impl: str = "auto",
                  a_keep: Optional[np.ndarray] = None,
                  b_keep: Optional[np.ndarray] = None) -> torch.Tensor:
    """Fused ``⊕-reduce(A ⊗.⊕ B, axis)`` — C is never materialized.

    ``axis=1`` ⊕-folds over columns → vector over ``a.row_space``;
    ``axis=0`` ⊕-folds over rows → vector over ``b.col_space``.  The
    reduction monoid is the semiring's own ⊕ (the only choice for which
    the fusion ``⊕_j ⊕_k A[i,k] ⊗ B[k,j]`` is exact).  Strategy mirrors
    :func:`matmul`; the bsr strategy runs the fused pair-list reduce
    kernel, the dense strategy the block-masked fused reduce kernel
    (:func:`repro_torch.kernels.bsr_spgemm.ops.bsr_spgemm_reduce`).
    """
    from repro_torch.kernels.bsr_spgemm.ops import (bsr_pairlist_reduce,
                                                    bsr_spgemm_reduce,
                                                    make_block_mask)

    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    _check_impl(impl)
    sr = get_semiring(semiring)
    dev = a.device
    with _stage("align", dev):
        a, b, ks = _contraction_aligned(a, b, sr)
    m, k, n = len(a.row_space), len(ks), len(b.col_space)
    out_len = m if axis == 1 else n
    with _stage("valid_host", dev):
        ra, ca, na = _valid_host(a)
        rb, cb, nb = _valid_host(b)
    ra, ca, a_vals = _apply_keep(a, ra, ca, na, a_keep)
    rb, cb, b_vals = _apply_keep(b, rb, cb, nb, b_keep)
    filtered = a_keep is not None or b_keep is not None
    if len(ra) == 0 or len(rb) == 0 or out_len == 0:
        return torch.full((max(out_len, 0),), sr.zero, dtype=torch.float32,
                          device=dev)

    if impl == "coo":
        # expand-join + one segment scatter: the fused epilogue on triples
        products = _exact_products(ca, rb, k)
        expand = max(8, _round_up(max(products, 1), 8))
        ar, ac, av = ((a.rows, a.cols, a.vals) if a_keep is None
                      else _pad_triples(ra, ca, a_vals, a.capacity, sr.zero))
        br, bc, bv = ((b.rows, b.cols, b.vals) if b_keep is None
                      else _pad_triples(rb, cb, b_vals, b.capacity, sr.zero))
        pr, pc, pv, _ = expand_join_coo(ar, ac, av, br, bc, bv,
                                        sr.mul, zero=sr.zero, expand=expand)
        keys = pr if axis == 1 else pc
        vec = torch.full((out_len,), sr.zero, dtype=torch.float32, device=dev)
        return scatter_combine(vec, keys, pv, sr)  # SENT keys drop

    def _dense() -> torch.Tensor:
        with _stage("densify", dev):
            if filtered:
                da = _scatter_dense(ra, ca, a_vals, m, k, sr.zero)
                db = _scatter_dense(rb, cb, b_vals, k, n, sr.zero)
                mask = make_block_mask(
                    _upload(ra, dev, torch.int32),
                    _upload(ca, dev, torch.int32),
                    torch.ones(len(ra), dtype=torch.bool, device=dev),
                    da.shape[0] // TILE, da.shape[1] // TILE)
            else:
                da, db = _densify_aligned(a, b, sr)
                mask = make_block_mask(a.rows, a.cols, a.valid_mask(),
                                       da.shape[0] // TILE,
                                       da.shape[1] // TILE)
        with _stage("kernel", dev):   # with the wrapper's fold
            vec = bsr_spgemm_reduce(da, mask, db, axis=axis, semiring=sr,
                                    impl=kernel_impl)
        return vec[:out_len]

    if impl == "dense":
        return _dense()  # uses no plan fields: skip the tile-pair join

    with _stage("plan", dev):
        plan = plan_matmul(ra, ca, rb, cb, m, k, n, impl=impl)
    if plan.impl == "dense":
        return _dense()

    # bsr strategy: fold tile products straight into per-output-block
    # vectors — no C tiles, no dedup (⊕ over all products per row/col IS
    # the answer).  Pairs regroup by output block (block-row for axis=1,
    # block-col for axis=0) so one kernel block owns each output block.
    if len(plan.pair_a) == 0:
        return torch.full((max(out_len, 0),), sr.zero, dtype=torch.float32,
                          device=dev)
    with _stage("pack_tiles", dev):
        a_tiles = pack_tiles(a_vals, plan.a_tile_of, plan.a_lr, plan.a_lc,
                             len(plan.a_blocks), TILE, TILE, sr.zero)
        b_tiles = pack_tiles(b_vals, plan.b_tile_of, plan.b_lr, plan.b_lc,
                             len(plan.b_blocks), TILE, TILE, sr.zero)
    with _stage("reduce_pairs", dev):
        pa, pb, pair_o, o_uniq = reduce_pairs(plan, axis)
    with _stage("kernel", dev):   # with the wrapper's checks
        blocks = bsr_pairlist_reduce(
            a_tiles, b_tiles, _upload(pa, dev, torch.int32),
            _upload(pb, dev, torch.int32), _upload(pair_o, dev, torch.int32),
            n_o=len(o_uniq), axis=axis, semiring=sr,
            impl=kernel_impl)                              # [n_o, TILE]

    with _stage("fold", dev):
        padded = _round_up(max(out_len, 1), TILE)
        vec = torch.full((padded,), sr.zero, dtype=torch.float32, device=dev)
        offs = torch.arange(TILE, device=dev)
        idx = _upload(o_uniq * TILE, dev)[:, None] + offs[None, :]
        vec = scatter_combine(vec, idx, blocks, sr)
    return vec[:out_len]
