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

from repro_torch.analysis.contracts import contract

from .coo import SENT, dedup_sorted_coo, expand_join_coo
from .semiring import PLUS_TIMES, Semiring, get_semiring, scatter_combine

__all__ = ["MatmulPlan", "plan_matmul", "matmul", "matmul_reduce",
           "bsr_matmul_coo", "bsr_tiles_coo", "pack_b_tiles", "pack_tiles",
           "estimate_out_nnz", "reduce_pairs",
           "tiles_to_coo", "stage_timing", "STAGE_MS", "TILE",
           "BSR_AUTO_EXPAND", "DistPlan", "dist_summary",
           "plan_from_summaries", "plan_dist_matmul", "suggest_grid"]

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


def pack_b_tiles(plan: MatmulPlan, b_vals: torch.Tensor, sr: Semiring, *,
                 bk: int = TILE, bn: int = TILE) -> torch.Tensor:
    """The plan's B entries (``b_vals`` in its entry order) packed into its
    B tiles ``[n_b, bk, bn]``, the operand :func:`bsr_tiles_coo` takes."""
    return pack_tiles(b_vals, plan.b_tile_of, plan.b_lr, plan.b_lc,
                      len(plan.b_blocks), bk, bn, sr.zero)


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


def bsr_tiles_coo(plan: MatmulPlan, a_vals: torch.Tensor,
                  b_tiles: torch.Tensor, sr: Semiring, out_capacity: int, *,
                  kernel_impl: str = "auto",
                  bm: int = TILE, bk: int = TILE):
    """The BSR contraction: the plan's A entries (``a_vals`` in the plan's
    entry order) packed into tiles, against B's tiles (``b_tiles``,
    :func:`pack_b_tiles`), the pair list
    contracted by :func:`repro_torch.kernels.bsr_spgemm.ops.bsr_pairlist`
    (the CUDA kernel on CUDA tensors, its plain torch version on CPU
    tensors; ``kernel_impl`` forwards to that dispatch) and the present C
    tiles read out as canonical COO.  Returns ``(rows, cols, vals,
    true_nnz)`` with ``min(true_nnz, out_capacity)`` entries, unpadded."""
    dev = a_vals.device
    if len(plan.pair_a) == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone(), torch.empty(
            0, dtype=torch.float32, device=dev), 0

    from repro_torch.kernels.bsr_spgemm.ops import bsr_pairlist

    with _stage("pack_tiles", dev):
        a_tiles = pack_tiles(a_vals, plan.a_tile_of, plan.a_lr, plan.a_lc,
                             len(plan.a_blocks), bm, bk, sr.zero)
    n_c = len(plan.c_blocks)
    with _stage("kernel", dev):   # with the wrapper's checks
        c_tiles = bsr_pairlist(
            a_tiles, b_tiles, plan.pair_a, plan.pair_b, plan.pair_c,
            n_c=n_c, semiring=sr, impl=kernel_impl)
    del a_tiles
    with _stage("tiles_to_coo", dev):
        return tiles_to_coo(c_tiles, plan.c_blocks, plan.m, plan.n, sr.zero,
                            out_capacity)


def bsr_matmul_coo(plan: MatmulPlan, a_vals: torch.Tensor,
                   b_vals: torch.Tensor, sr: Semiring, out_capacity: int, *,
                   kernel_impl: str = "auto",
                   bm: int = TILE, bk: int = TILE, bn: int = TILE):
    """Execute the BSR strategy: packed tiles in, canonical COO out
    (:func:`bsr_tiles_coo`, padded to ``out_capacity``).

    Returns ``(rows, cols, vals, nnz, overflowed)``; the extraction runs
    over the **present C tiles only** — never over |rowspace|×|colspace| —
    so peak memory is tiles + the output COO.
    """
    with _stage("pack_tiles", a_vals.device):
        b_tiles = pack_b_tiles(plan, b_vals, sr, bk=bk, bn=bn)
    r, c, v, true_nnz = bsr_tiles_coo(plan, a_vals, b_tiles, sr, out_capacity,
                                      kernel_impl=kernel_impl, bm=bm, bk=bk)
    del b_tiles
    overflowed = true_nnz > out_capacity
    if overflowed:
        _warn_overflow(true_nnz, out_capacity, "bsr_matmul_coo")
    r, c, v = pad_to_cap(r, c, v, out_capacity, sr.zero)
    nnz = torch.tensor(min(true_nnz, out_capacity), dtype=torch.int32,
                       device=a_vals.device)
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


@contract(collectives=0, name="spgemm.matmul",
          note="single-device planned product: BSR pair-list kernel path")
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


@contract(collectives=0, name="spgemm.matmul_reduce",
          note="fused epilogue: C tiles never materialized")
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
            a_tiles, b_tiles, pa, pb, pair_o,
            n_o=len(o_uniq), axis=axis, semiring=sr,
            impl=kernel_impl)                              # [n_o, TILE]

    with _stage("fold", dev):
        padded = _round_up(max(out_len, 1), TILE)
        vec = torch.full((padded,), sr.zero, dtype=torch.float32, device=dev)
        offs = torch.arange(TILE, device=dev)
        idx = _upload(o_uniq * TILE, dev)[:, None] + offs[None, :]
        vec = scatter_combine(vec, idx, blocks, sr)
    return vec[:out_len]


# ---------------------------------------------------------------------------
# Distribution cost model: which communication pattern should a sharded
# product use?  Exact per-entry product counts (two searchsorteds over B's
# contraction ranks) turn into triples-moved estimates for the three
# DistAssoc strategies, and the cheapest wins — the D4M.jl / Graphulo
# observation that the win at scale comes from moving the *smaller* data
# (B slices or partial products), not from one hard-coded pattern.
#
# The JAX package runs the model on the single controller over the
# ``[P, cap]`` arrays of every shard.  Here each rank holds one shard, so
# the model splits in two: :func:`dist_summary` reduces one shard to a
# small int64 vector (its row of every table the model builds), one
# ``all_gather`` stacks the ranks' vectors, and :func:`plan_from_summaries`
# runs the same plan on every rank.  :func:`plan_dist_matmul` and
# :func:`suggest_grid` keep the JAX signatures on top of the two.
# ---------------------------------------------------------------------------

def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


# Weight of per-shard sort work (expand-join sorts + the canonical dedup
# merge) relative to one moved triple.  The critical-path sort sizes are
# the SAME padded capacities the movement terms use, so skew prices both:
# a hub row inflates a bucket, the bucket inflates the exchange AND the
# merge that consumes it.  Sorting a resident triple costs more than
# copying one, so the weight leans the chooser toward the strategy with
# the smallest per-shard merge when movement is close.
_SORT_WEIGHT = 8.0

# Per-shard expand size above which DistAssoc's replicate path swaps its
# local compute from the coo expand-join to the tiled pair-list (BSR)
# program.  That swap plans the pair lists on host — a scan of ALL of B
# per shard — so the distribution cost model charges replicate for it
# (see plan_dist_matmul); the sharded strategies never pay it because each
# shard only ever contracts one B block.
BSR_AUTO_EXPAND = 1 << 14


@dataclasses.dataclass
class DistPlan:
    """Host-side communication plan for one sharded ``A ⊗.⊕ B``.

    ``costs`` holds the modeled data movement per strategy in **triples**
    (COO entries: 12 bytes each — the unit every term shares, so bytes
    cancel).  Replicated/staged movement and collective movement are
    counted at the same weight, but the collective terms use the *padded*
    capacities (``bucket_cap`` / ``block_cap``): a hub row that
    concentrates partial products into one bucket inflates the all-to-all
    estimate exactly as it inflates the real exchange.
    """

    strategy: str                  # "replicate" | "all_to_all" | "2d"
    grid: Tuple[int, int]          # (pr, pc); (n_shards, 1) off the 2d path
    bucket_cap: int                # all_to_all per-(src, dest) bucket slots
    block_cap: int                 # 2d staged B-block capacity (triples)
    expands: dict                  # strategy → per-shard expand-join slots
    costs: dict                    # strategy → modeled triples moved

    @property
    def expand(self) -> int:
        return self.expands[self.strategy]


def _cap8(x: int) -> int:
    """A static buffer size: ``x`` rounded up to 8, at least 8."""
    return int(max(8, _round_up(int(x) or 1, 8)))


def _grid_pcs(n_shards: int, grid: Optional[Tuple[int, int]]):
    """The contraction-block counts the model sizes: the forced grid's
    ``pc``, or every divisor of ``n_shards``."""
    if grid is None:
        return _divisors(n_shards)
    pr, pc = grid
    if pr * pc != n_shards:
        raise ValueError(f"grid {grid} does not tile {n_shards} shards")
    return [pc]


def _block_products(a_cols: np.ndarray, counts: np.ndarray,
                    bounds: np.ndarray) -> np.ndarray:
    """Products of one shard's entries per contraction block of
    ``bounds`` (int64 ``[len(bounds) - 1]``)."""
    nb = len(bounds) - 1
    kb = np.searchsorted(bounds[1:], a_cols, side="right").clip(
        0, max(nb - 1, 0))
    # float64 sums of integer counts are exact below 2^53 products
    return np.bincount(kb, weights=counts, minlength=nb).astype(np.int64)


def dist_summary(a_rows: np.ndarray, a_cols: np.ndarray,
                 counts: np.ndarray, k: int, n_shards: int, *,
                 grid: Optional[Tuple[int, int]] = None,
                 a2a_bounds: Optional[np.ndarray] = None) -> np.ndarray:
    """One shard's row of every table the cost model builds, as one int64
    vector: ``[nnz, products, products per all-to-all contraction block
    (n_shards), products per block of each pc of _grid_pcs (pc each)]``.

    ``a_rows``/``a_cols`` are the shard's ``[cap]`` SENT-padded rank
    arrays, cols on the contraction space; ``counts`` the exact per-entry
    B-run lengths (0 for SENT entries); ``a2a_bounds`` a resident B's
    partition in the merged rank space (else equal ranges of ``k``).
    Every rank's vector has the same length, so one ``all_gather`` stacks
    them for :func:`plan_from_summaries`.
    """
    a_cols = np.asarray(a_cols).ravel()
    counts = np.asarray(counts, np.int64).ravel()
    bnds = (np.asarray(a2a_bounds, np.int64) if a2a_bounds is not None
            else np.linspace(0, k, n_shards + 1).astype(np.int64))
    parts = [np.asarray([int((np.asarray(a_rows) != int(SENT)).sum()),
                         int(counts.sum())], np.int64),
             _block_products(a_cols, counts, bnds)]
    for pc in _grid_pcs(n_shards, grid):
        parts.append(_block_products(
            a_cols, counts, np.linspace(0, k, pc + 1).astype(np.int64)))
    return np.concatenate(parts)


def _grid_cost(n_shards: int, pc: int, table: np.ndarray, k: int,
               b_rows: np.ndarray):
    """``(cost, round_expand, block_cap)`` of the grid ``(P/pc, pc)`` from
    its ``[P, pc]`` product table."""
    pr = n_shards // pc
    round_expand = _cap8(table.max(initial=0))
    bnds = np.linspace(0, k, pc + 1).astype(np.int64)
    block_cap = _cap8(np.diff(np.searchsorted(b_rows, bnds)).max(initial=0))
    cost = (pr * len(b_rows) + n_shards * (pc - 1) * block_cap
            + _SORT_WEIGHT * pc * round_expand)
    return cost, round_expand, block_cap


def _best_grid(n_shards: int, k: int, tables, b_rows: np.ndarray):
    """The cheapest grid of ``tables`` (``pc`` → ``[P, pc]`` products):
    ``((pr, pc), round_expand, block_cap, cost)``."""
    best = None
    for pc, table in tables.items():
        cost, round_expand, block_cap = _grid_cost(n_shards, pc, table, k,
                                                   b_rows)
        if best is None or cost < best[0]:
            best = (cost, (n_shards // pc, pc), round_expand, block_cap)
    return best[1], best[2], best[3], best[0]


def _grid_tables(summaries: np.ndarray, n_shards: int,
                 grid: Optional[Tuple[int, int]]):
    """``pc`` → the ``[P, pc]`` product table, cut from stacked
    summaries."""
    tables, off = {}, 2 + n_shards
    for pc in _grid_pcs(n_shards, grid):
        tables[pc] = summaries[:, off:off + pc]
        off += pc
    return tables


def suggest_grid(n_shards: int, k: int, a_cols: np.ndarray,
                 counts: np.ndarray, b_rows: np.ndarray):
    """Pick the 2D process grid ``(pr, pc)`` from nnz structure.

    Models each divisor split ``pr·pc = n_shards`` (``pc`` = contraction
    blocks ring-shifted through the shards, ``pr`` = replication factor of
    each block at staging) and returns the grid minimizing::

        pr·nnz(B)  +  n_shards·(pc−1)·block_cap  +  w·pc·round_expand

    — staged B replication vs ring traffic vs per-shard merge work
    (``w`` = :data:`_SORT_WEIGHT`), all in triples — with the per-round
    expand size, staged block capacity and cost of the winner.
    ``a_cols``/``counts`` are the ``[P, cap]`` contraction ranks and
    per-entry product counts (SENT entries carry count 0); ``b_rows`` the
    sorted valid contraction ranks of B.
    """
    pcs = _divisors(n_shards)
    tables = {pc: np.stack([
        _block_products(a_cols[s], np.asarray(counts[s], np.int64),
                        np.linspace(0, k, pc + 1).astype(np.int64))
        for s in range(counts.shape[0])]) for pc in pcs}
    return _best_grid(n_shards, k, tables, b_rows)


def plan_from_summaries(summaries: np.ndarray, b_rows: np.ndarray, k: int,
                        n_shards: int, *, b_resident: bool = False,
                        grid: Optional[Tuple[int, int]] = None) -> DistPlan:
    """Choose replicate / all-to-all / 2D from the stacked
    :func:`dist_summary` rows of every shard (``[P, L]``) and B's sorted
    valid contraction ranks.  Modeled cost = movement +
    ``w``·(per-shard sort work), ``w`` = :data:`_SORT_WEIGHT`::

        replicate:   P·nnz(B)                        + w·expand
        all_to_all:  P·nnz(A) + stage(B) + P²·bucket_cap
                                         + w·(expand + P·bucket_cap)
        2d(pr, pc):  pr·nnz(B) + P·(pc−1)·block_cap + w·pc·round_expand

    The sort terms make the chooser load-balance-aware: A's row skew
    concentrates ``replicate``'s and ``2d``'s expand on the hub shard (A
    never moves), while ``all_to_all`` re-buckets products by contraction
    block — its expand is the *column* max of the product table, not the
    row max.  ``stage(B)`` is 0 for a resident B (its row partition IS a
    contraction partition, reused in place).  ``grid`` forces the 2D
    grid.
    """
    P = n_shards
    s = np.asarray(summaries, np.int64).reshape(P, -1)
    nnz_a = int(s[:, 0].sum())
    nnz_b = len(b_rows)
    expand_rep = _cap8(s[:, 1].max(initial=0))
    # the [dest, src] product table: column sums size the compute
    # expansion, the largest cell the exchange buckets
    table = s[:, 2:2 + P]
    bucket_cap = _cap8(table.max(initial=0))
    expand_a2a = _cap8(table.sum(axis=0).max(initial=0))
    grid_2d, round_expand, block_cap, cost_2d = _best_grid(
        P, k, _grid_tables(s, P, grid), b_rows)

    cost_rep = float(P * nnz_b + _SORT_WEIGHT * expand_rep)
    if expand_rep >= BSR_AUTO_EXPAND:
        # replicate's local compute will switch to the pair-list program,
        # whose host planning rescans B once per shard
        cost_rep += float(_SORT_WEIGHT * P * nnz_b)
    costs = {
        "replicate": cost_rep,
        "all_to_all": float(P * nnz_a + (0 if b_resident else nnz_b)
                            + P * P * bucket_cap
                            + _SORT_WEIGHT * (expand_a2a
                                              + P * bucket_cap)),
        "2d": float(cost_2d),
    }
    strategy = "replicate" if P == 1 else min(costs, key=costs.get)
    expands = {"replicate": expand_rep, "all_to_all": expand_a2a,
               "2d": round_expand}
    return DistPlan(strategy=strategy, grid=grid_2d, bucket_cap=bucket_cap,
                    block_cap=block_cap, expands=expands, costs=costs)


def plan_dist_matmul(a_rows: np.ndarray, a_cols: np.ndarray,
                     counts: np.ndarray, b_rows: np.ndarray, k: int,
                     n_shards: int, *, b_resident: bool = False,
                     grid: Optional[Tuple[int, int]] = None,
                     a2a_bounds: Optional[np.ndarray] = None) -> DistPlan:
    """Choose replicate / all-to-all / 2D for one sharded product from the
    ``[n_shards, cap]`` SENT-padded rank arrays of every shard (cols on
    the contraction space), their exact per-entry B-run lengths
    ``counts`` and B's sorted valid contraction ranks ``b_rows``: the
    stacked :func:`dist_summary` of each shard through
    :func:`plan_from_summaries`.  ``a2a_bounds`` carries a resident B's
    partition in the merged rank space, so the product table matches the
    blocks the program will contract."""
    _grid_pcs(n_shards, grid)
    summaries = np.stack([
        dist_summary(a_rows[s], a_cols[s], counts[s], k, n_shards,
                     grid=grid, a2a_bounds=a2a_bounds)
        for s in range(counts.shape[0])])
    return plan_from_summaries(summaries, b_rows, k, n_shards,
                               b_resident=b_resident, grid=grid)
