"""Each ported kernel's plain torch version against the JAX package: its
``ref.py`` oracle AND its Pallas body run in interpret mode, under every
semiring, plus the port's dispatch rules.

The CUDA kernels themselves need a card: ``test_torch_cuda.py`` holds them
against these plain versions there (``chip_smoke.py`` does too, at the main
path's shapes)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import ops as j_bsr
from repro.kernels.bsr_spgemm import ref as j_bsr_ref
from repro.kernels.range_extract import ops as j_rm
from repro.kernels.range_extract.ref import range_mask_ref as j_rm_ref
from repro.kernels.semiring_matmul import ops as j_sm
from repro.kernels.semiring_matmul.ref import semiring_matmul_ref as j_sm_ref
from repro.kernels.sorted_merge import ops as j_rc
from repro.kernels.sorted_merge.ref import rank_count_ref as j_rc_ref
from repro_torch.core import REGISTRY
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spgemm import ops as t_bsr
from repro_torch.kernels.bsr_spgemm import ref as t_bsr_ref
from repro_torch.kernels.range_extract import ops as t_rm
from repro_torch.kernels.range_extract.ref import range_mask_ref as t_rm_ref
from repro_torch.kernels.semiring_matmul import ops as t_sm
from repro_torch.kernels.semiring_matmul.ref import semiring_matmul_ref as t_sm_ref
from repro_torch.kernels.sorted_merge import ops as t_rc
from repro_torch.kernels.sorted_merge.ref import rank_count_ref as t_rc_ref

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (SEMIRINGS, _reset_port_stats,  # noqa: F401
                            assert_same, warm_jax)

SENT = 2 ** 31 - 1


def _values(rng, shape, sr, floats):
    """Random operands: positive floats (sums without cancellation, so a
    relative tolerance is meaningful), or small integers (exact under every
    ⊕); about a third of the entries hold the semiring zero."""
    v = (rng.uniform(0.5, 1.5, shape) if floats
         else rng.integers(1, 5, shape)).astype(np.float32)
    v[rng.random(shape) < 0.35] = REGISTRY[sr].zero
    return v


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles):
    """The JAX side of the parametrised kernel comparisons (each oracle and
    each Pallas body in interpret mode), run first on threads so that
    their programs compile side by side; each test then makes the same
    calls."""
    P = functools.partial
    calls = []
    for sr in SEMIRINGS:
        for shape in SM_SHAPES:
            a, b = (jnp.asarray(x) for x in _sm_case(sr, shape))
            calls += [P(j_sm_ref, a, b, semiring=sr),
                      P(j_sm.semiring_matmul, a, b, semiring=sr,
                        impl="interpret")]
        fl = sr == "plus_times"
        a, b, pa, pb, pc, n_c = _pairlist_case(np.random.default_rng(11),
                                               sr, fl)
        args = [jnp.asarray(x) for x in (a, b, pa, pb, pc)]
        calls += [P(j_bsr_ref.bsr_pairlist_ref, *args, n_c=n_c, semiring=sr),
                  P(j_bsr.bsr_pairlist, *args, n_c=n_c, semiring=sr,
                    impl="interpret")]
        for axis in (0, 1):
            a, b, pa, pb, po, n_o = _pairlist_case(
                np.random.default_rng(12 + axis), sr, fl)
            args = [jnp.asarray(x) for x in (a, b, pa, pb, po)]
            kw = {"n_o": n_o, "axis": axis, "semiring": sr}
            calls += [P(j_bsr_ref.bsr_pairlist_reduce_ref, *args, **kw),
                      P(j_bsr.bsr_pairlist_reduce, *args, impl="interpret",
                        **kw)]
            args = [jnp.asarray(x) for x in _spgemm_reduce_case(sr, axis)]
            calls += [P(j_bsr_ref.bsr_spgemm_reduce_ref, *args, axis=axis,
                        semiring=sr),
                      P(j_bsr.bsr_spgemm_reduce, *args, axis=axis,
                        semiring=sr, impl="interpret")]
        args = [jnp.asarray(x) for x in _spgemm_case(sr)]
        calls += [P(j_bsr_ref.bsr_spgemm_ref, *args, semiring=sr),
                  P(j_bsr.bsr_spgemm, *args, semiring=sr, impl="interpret")]
    for ni, si, nj, sj in _RANK_CASES:
        i, j = (jnp.asarray(x) for x in _rank_case(ni, si, nj, sj))
        calls.append(P(j_rc_ref, i, j))
        if nj:
            calls.append(P(j_rc.rank_count, i, j, impl="interpret"))
    warm_jax(calls)


# -- range_mask --------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 2051])
def test_range_mask_ref_matches(n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 60, n).astype(np.int32)
    cols = rng.integers(0, 60, n).astype(np.int32)
    rows[rng.random(n) < 0.1] = SENT
    for b in [(0, 60, 0, 60), (5, 40, 10, 30), (30, 30, 0, 60), (0, 60, 59, 60)]:
        got = t_rm_ref(torch.from_numpy(rows), torch.from_numpy(cols), b)
        jb = jnp.asarray(b, jnp.int32)
        want = j_rm_ref(jnp.asarray(rows), jnp.asarray(cols), jb)
        body = j_rm.range_mask(jnp.asarray(rows), jnp.asarray(cols), jb,
                               impl="interpret")
        assert_same(got, want)
        assert_same(got, body)
        # the dispatch takes the plain version for CPU tensors, and bounds
        # as a tensor of any shape
        assert_same(t_rm.range_mask(torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.tensor([b], dtype=torch.int32)),
                    want)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "sentinel-padded"])
def test_range_mask_gated_bytes(case):
    """The kernel's bound counts rows and keep for every entry and cols
    only where the row lies in the box: 8N + 4·(rows inside), whatever the
    order; sentinels are never inside (not even a box up to 2^31 - 1)."""
    rng = np.random.default_rng(7)
    n = 5003
    rows = np.sort(rng.integers(0, 900, n)).astype(np.int32)
    if case == "unsorted":
        rows = rng.permutation(rows)
    if case == "sentinel-padded":
        rows[n - 700:] = SENT
    t_rows = torch.from_numpy(rows)
    for b in [(100, 300, 0, 5), (0, 900, 0, 900), (400, SENT, 7, 8),
              (5, 5, 0, 900)]:
        inside = int(((rows >= b[0]) & (rows < b[1]) & (rows != SENT)).sum())
        want = 8 * n + 4 * inside
        assert t_rm.range_mask_bytes(t_rows, b) == want
        assert t_rm.range_mask_bytes(t_rows, torch.tensor(b)) == want
    assert t_rm.range_mask_bytes(t_rows, (0, 900, 0, 1)) == (
        12 * n if case != "sentinel-padded" else 12 * n - 4 * 700)


# -- semiring_matmul ---------------------------------------------------------------

SM_SHAPES = [(32, 48, 16), (130, 70, 150)]


def _sm_case(sr, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    floats = sr == "plus_times"
    return _values(rng, (m, k), sr, floats), _values(rng, (k, n), sr, floats)


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("shape", SM_SHAPES)
def test_semiring_matmul_ref_matches(sr, shape):
    a, b = _sm_case(sr, shape)
    got = t_sm_ref(torch.from_numpy(a), torch.from_numpy(b), semiring=sr)
    assert_same(got, j_sm_ref(jnp.asarray(a), jnp.asarray(b), semiring=sr),
                sr)
    assert_same(got, j_sm.semiring_matmul(jnp.asarray(a), jnp.asarray(b),
                                          semiring=sr, impl="interpret"), sr)
    assert_same(t_sm.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                     semiring=sr), got, sr)


@pytest.mark.parametrize("sr", ["max_plus", "min_plus"])
def test_semiring_matmul_pad_keeps_result(sr):
    """The kernel path pads with the semiring zero to (128, 32, 128)
    multiples; padding a plain product the same way changes nothing."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_values(rng, (40, 33), sr, False))
    b = torch.from_numpy(_values(rng, (33, 50), sr, False))
    z = REGISTRY[sr].zero
    ap = t_sm._pad_to(a, t_sm.BM, t_sm.BK, z)
    bp = t_sm._pad_to(b, t_sm.BK, t_sm.BN, z)
    assert ap.shape == (128, 64) and bp.shape == (64, 128)
    assert_same(t_sm_ref(ap, bp, semiring=sr)[:40, :50],
                t_sm_ref(a, b, semiring=sr), sr)


# -- pair-list kernels ---------------------------------------------------------------

def _pairlist_case(rng, sr, floats, n_a=2, n_b=3, n_pairs=5):
    a = _values(rng, (n_a, 128, 128), sr, floats)
    b = _values(rng, (n_b, 128, 128), sr, floats)
    pa = rng.integers(0, n_a, n_pairs).astype(np.int32)
    pb = rng.integers(0, n_b, n_pairs).astype(np.int32)
    pc = np.sort(rng.integers(0, 3, n_pairs)).astype(np.int32)
    pc = np.searchsorted(np.unique(pc), pc).astype(np.int32)  # cover 0..n-1
    return a, b, pa, pb, pc, int(pc.max()) + 1


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_ref_matches(sr):
    a, b, pa, pb, pc, n_c = _pairlist_case(np.random.default_rng(11), sr,
                                           sr == "plus_times")
    t_args = [torch.from_numpy(x) for x in (a, b, pa, pb, pc)]
    j_args = [jnp.asarray(x) for x in (a, b, pa, pb, pc)]
    got = t_bsr_ref.bsr_pairlist_ref(*t_args, n_c=n_c, semiring=sr)
    assert_same(got, j_bsr_ref.bsr_pairlist_ref(*j_args, n_c=n_c,
                                                semiring=sr), sr)
    assert_same(got, j_bsr.bsr_pairlist(*j_args, n_c=n_c, semiring=sr,
                                        impl="interpret"), sr)
    assert_same(t_bsr.bsr_pairlist(*t_args, n_c=n_c, semiring=sr), got, sr)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_reduce_ref_matches(sr, axis):
    a, b, pa, pb, po, n_o = _pairlist_case(np.random.default_rng(12 + axis),
                                           sr, sr == "plus_times")
    t_args = [torch.from_numpy(x) for x in (a, b, pa, pb, po)]
    j_args = [jnp.asarray(x) for x in (a, b, pa, pb, po)]
    got = t_bsr_ref.bsr_pairlist_reduce_ref(*t_args, n_o=n_o, axis=axis,
                                            semiring=sr)
    assert got.shape == (n_o, 128)
    assert_same(got, j_bsr_ref.bsr_pairlist_reduce_ref(
        *j_args, n_o=n_o, axis=axis, semiring=sr), sr)
    assert_same(got, j_bsr.bsr_pairlist_reduce(
        *j_args, n_o=n_o, axis=axis, semiring=sr, impl="interpret"), sr)
    assert_same(t_bsr.bsr_pairlist_reduce(*t_args, n_o=n_o, axis=axis,
                                          semiring=sr), got, sr)


def _spgemm_reduce_case(sr, axis):
    rng = np.random.default_rng(21 + axis)
    floats = sr == "plus_times"
    return (_values(rng, (256, 256), sr, floats),
            np.array([[1, 0], [1, 1]], np.int32),
            _values(rng, (256, 128), sr, floats))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_reduce_ref_matches(sr, axis):
    a, mask, b = _spgemm_reduce_case(sr, axis)
    got = t_bsr_ref.bsr_spgemm_reduce_ref(
        torch.from_numpy(a), torch.from_numpy(mask), torch.from_numpy(b),
        axis=axis, semiring=sr)
    ja, jm, jb = jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b)
    assert_same(got, j_bsr_ref.bsr_spgemm_reduce_ref(ja, jm, jb, axis=axis,
                                                     semiring=sr), sr)
    assert_same(got, j_bsr.bsr_spgemm_reduce(ja, jm, jb, axis=axis,
                                             semiring=sr, impl="interpret"),
                sr)
    assert_same(t_bsr.bsr_spgemm_reduce(
        torch.from_numpy(a), torch.from_numpy(mask), torch.from_numpy(b),
        axis=axis, semiring=sr), got, sr)


def _spgemm_case(sr):
    rng = np.random.default_rng(25)
    floats = sr == "plus_times"
    return (_values(rng, (256, 384), sr, floats),
            np.array([[1, 0, 1], [0, 0, 0]], np.int32),
            _values(rng, (384, 128), sr, floats))


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_ref_matches(sr):
    """The materializing block-masked product: A's absent tiles hold values
    that must not count."""
    a, mask, b = _spgemm_case(sr)
    t_args = [torch.from_numpy(x) for x in (a, mask, b)]
    j_args = [jnp.asarray(x) for x in (a, mask, b)]
    got = t_bsr_ref.bsr_spgemm_ref(*t_args, semiring=sr)
    assert_same(got, j_bsr_ref.bsr_spgemm_ref(*j_args, semiring=sr), sr)
    assert_same(got, j_bsr.bsr_spgemm(*j_args, semiring=sr,
                                      impl="interpret"), sr)
    # impl="auto" on CPU tensors: the plain version under every semiring
    # (the card's routes, TF32 for (+, ×) and the ring for the rest, are
    # never asked for), with no launch counted
    before = dict(LAUNCHES)
    assert_same(t_bsr.bsr_spgemm(*t_args, semiring=sr, impl="auto"), got, sr)
    assert dict(LAUNCHES) == before
    # the empty block-row is the semiring zero
    assert bool((got[128:] == REGISTRY[sr].zero).all())


# -- rank_count / merge_positions / overlay_scatter --------------------------------

def _sorted_keys(rng, n, n_sent):
    """n sorted, repetition-free int32 keys whose last n_sent are SENT."""
    k = np.sort(rng.choice(2 * n + 8, n - n_sent,
                           replace=False)).astype(np.int32)
    return np.concatenate([k, np.full(n_sent, SENT, np.int32)])


# (1) JAX pads both sides to block multiples: ni, nj off the multiples
# (2) the trap: sentinel entries of i, where the Pallas path counts its own
#     pad sentinels in hit and differs from searchsorted
def _rank_case(ni, si, nj, sj):
    rng = np.random.default_rng(ni + nj)
    return _sorted_keys(rng, ni, si), _sorted_keys(rng, nj, sj)


_RANK_CASES = [(5, 2, 6, 4), (1, 0, 1, 0), (37, 5, 29, 0), (600, 40, 520, 100),
               (8, 0, 0, 0)]


@pytest.mark.parametrize("ni,si,nj,sj", _RANK_CASES)
def test_rank_count_ref_matches(ni, si, nj, sj):
    i, j = _rank_case(ni, si, nj, sj)
    got = t_rc_ref(torch.from_numpy(i), torch.from_numpy(j))
    want = j_rc_ref(jnp.asarray(i), jnp.asarray(j))
    for g, w in zip(got, want):            # every entry, sentinels included
        assert_same(g, w)
        assert g.dtype == torch.int32
    for g, w in zip(got, t_rc.rank_count(torch.from_numpy(i),
                                         torch.from_numpy(j))):
        assert torch.equal(g, w)
    if nj:                                 # Pallas: valid entries only
        body = j_rc.rank_count(jnp.asarray(i), jnp.asarray(j),
                               impl="interpret")
        ok = i != SENT
        for g, w in zip(got, body):
            np.testing.assert_array_equal(g.numpy()[ok], np.asarray(w)[ok])


def test_rank_count_sentinel_trap_pinned():
    """i=[1,3,5,S,S], j=[3,4,S,S,S,S]: searchsorted gives hit [0,1,0,4,4]
    (the port's contract, on every entry); the JAX Pallas path gives
    [0,1,0,6,6] (it counts its pad sentinels); valid entries agree."""
    i = np.array([1, 3, 5, SENT, SENT], np.int32)
    j = np.array([3, 4, SENT, SENT, SENT, SENT], np.int32)
    rank, hit = t_rc.rank_count(torch.from_numpy(i), torch.from_numpy(j))
    assert rank.tolist() == [0, 0, 2, 2, 2] and hit.tolist() == [0, 1, 0, 4, 4]
    _, j_hit = j_rc.rank_count(jnp.asarray(i), jnp.asarray(j),
                               impl="interpret")
    assert np.asarray(j_hit).tolist() == [0, 1, 0, 6, 6]
    ip, _, _ = t_rc.merge_positions(torch.from_numpy(i), torch.from_numpy(j))
    j_ip, _, _ = j_rc.merge_positions(jnp.asarray(i), jnp.asarray(j),
                                      impl="ref")
    assert ip.tolist() == np.asarray(j_ip).tolist() == [0, 1, 3, 4, 1]


def _split(a, b, diag, first, lanes):
    """csrc/rank_count.cu's ``warp_split`` with ``lanes`` lanes: the count
    of a among the first ``diag`` merged elements, each round probing one
    split per lane and keeping the range between the last true and the
    first false probe."""
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while hi > lo:
        span = hi - lo
        if span <= lanes:
            return lo + sum(bool(first(a[lo + l], b[diag - lo - l - 1]))
                            for l in range(span))
        xs = [lo + l * span // lanes for l in range(lanes)]
        k = sum(bool(first(a[x], b[diag - x - 1])) for x in xs)
        if k == 0:
            return lo
        nxt = lo + k * span // lanes if k < lanes else hi
        lo, hi = lo + (k - 1) * span // lanes + 1, nxt
    return lo


def _merge_path_rank_count(i, j, *, threads, items, lanes):
    """A numpy model of the merge-path kernel: for each tie order, blocks of
    threads·items merged elements, each block's window from two splits,
    each thread's start by binary search in the window and ``items``
    sequential merge steps; rank from the i-first order, hit as the sum of
    +upper (j-first order) and -lower, as the kernel's reductions do."""
    tile = threads * items
    total = len(i) + len(j)
    rank = np.full(len(i), -1, np.int64)
    hit = np.zeros(len(i), np.int64)
    for lower in (True, False):
        def first(x, y):                   # does i's x go before j's y?
            return x <= y if lower else x < y
        seen = np.zeros(len(i), bool)
        for d0 in range(0, total, tile):
            d1 = min(d0 + tile, total)
            a0, a1 = (_split(i, j, d, first, lanes) for d in (d0, d1))
            b0, b1 = d0 - a0, d1 - a1
            si, sj = i[a0:a1], j[b0:b1]
            na, nb = len(si), len(sj)
            assert na + nb == d1 - d0
            cnt = np.full(na, -1, np.int64)
            for t in range(threads):
                diag = min(t * items, na + nb)
                lo, hi = max(0, diag - nb), min(diag, na)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if first(si[mid], sj[diag - mid - 1]):
                        lo = mid + 1
                    else:
                        hi = mid
                x, y = lo, diag - lo
                for _ in range(items):
                    if x + y < na + nb:
                        if y >= nb or (x < na and first(si[x], sj[y])):
                            cnt[x] = b0 + y
                            x += 1
                        else:
                            y += 1
            assert (cnt >= 0).all()        # each i of the window merged once
            seen[a0:a1] = True
            if lower:
                rank[a0:a1] = cnt
                hit[a0:a1] -= cnt
            else:
                hit[a0:a1] += cnt
        assert seen.all()
    return rank, hit


def _runs_with_tail(rng, n, vmax, n_sent):
    """n sorted int32 keys from [0, vmax) (long runs of equal values when
    vmax is small) whose last n_sent are SENT."""
    k = np.sort(rng.integers(0, vmax, n - n_sent)).astype(np.int32)
    return np.concatenate([k, np.full(n_sent, SENT, np.int32)])


@pytest.mark.parametrize("ni,si,nj,sj,vmax,threads,items,lanes", [
    (40, 10, 60, 25, 6, 2, 3, 4),          # runs and sentinel tails span blocks
    (300, 20, 5, 2, 50, 2, 4, 4),          # Ni >> Nj
    (5, 1, 300, 40, 50, 3, 2, 4),          # Nj >> Ni
    (2000, 300, 3000, 700, 40, 4, 8, 32),  # 32-way splits, many rounds
    (3000, 800, 2500, 600, 5000, 256, 8, 32),  # the kernel's own sizes
])
def test_merge_path_model_matches_rank_count_ref(ni, si, nj, sj, vmax,
                                                 threads, items, lanes):
    """The merge-path partition and per-thread merge of csrc/rank_count.cu,
    in both tie orders, give searchsorted's counts on every entry (held
    against the JAX package's reference)."""
    rng = np.random.default_rng(ni * 7 + nj)
    i = _runs_with_tail(rng, ni, vmax, si)
    j = _runs_with_tail(rng, nj, vmax, sj)
    for p, q in ((i, j), (j, i)):
        rank, hit = _merge_path_rank_count(p, q, threads=threads,
                                           items=items, lanes=lanes)
        want = j_rc_ref(jnp.asarray(p), jnp.asarray(q))
        np.testing.assert_array_equal(rank, np.asarray(want[0]))
        np.testing.assert_array_equal(hit, np.asarray(want[1]))


def test_merge_path_model_pinned_sentinel_case():
    """i=[1,3,5,S,S], j=[3,4,S,S,S,S] through the model at blocks of 2 and
    4 merged elements: hit = [0, 1, 0, 4, 4], as searchsorted gives."""
    i = np.array([1, 3, 5, SENT, SENT], np.int32)
    j = np.array([3, 4, SENT, SENT, SENT, SENT], np.int32)
    for threads, items in ((1, 2), (2, 2)):
        rank, hit = _merge_path_rank_count(i, j, threads=threads,
                                           items=items, lanes=2)
        assert rank.tolist() == [0, 0, 2, 2, 2]
        assert hit.tolist() == [0, 1, 0, 4, 4]


@pytest.mark.parametrize("ni,si,nj,sj", _RANK_CASES)
def test_merge_positions_and_overlay_scatter_match(ni, si, nj, sj):
    rng = np.random.default_rng(7 * ni + nj)
    i = _sorted_keys(rng, ni, si)
    j = _sorted_keys(rng, nj, sj)
    ti, tj = torch.from_numpy(i), torch.from_numpy(j)
    ji, jj = jnp.asarray(i), jnp.asarray(j)
    got = t_rc.merge_positions(ti, tj)
    for g, w in zip(got, j_rc.merge_positions(ji, jj, impl="ref")):
        assert_same(g, w)                  # every entry against the ref
    dst = t_rc.overlay_scatter(ti, tj)
    ok_i, ok_j = i != SENT, j != SENT
    for g, w in zip(dst, j_rc.overlay_scatter(ji, jj, impl="ref")):
        assert_same(g, w)
    if ni and nj:                          # Pallas: valid entries only
        for g, w, ok in zip(dst, j_rc.overlay_scatter(ji, jj,
                                                      impl="interpret"),
                            (ok_i, ok_j, ok_j)):
            np.testing.assert_array_equal(g.numpy()[ok], np.asarray(w)[ok])
    # the union layout: valid slots are 0..U-1, each key in one slot, and
    # every sentinel goes to the out-of-bounds slot
    i_dst, j_dst, j_dup = dst
    union = np.union1d(i[ok_i], j[ok_j])
    slots = np.full(ni + nj + 1, -1, np.int64)
    slots[i_dst.numpy()[ok_i]] = i[ok_i]
    slots[j_dst.numpy()[ok_j]] = j[ok_j]
    np.testing.assert_array_equal(slots[:len(union)], union)
    assert (i_dst.numpy()[~ok_i] == ni + nj).all()
    assert (j_dst.numpy()[~ok_j] == ni + nj).all()
    np.testing.assert_array_equal(j_dup.numpy()[ok_j], np.isin(j[ok_j], i))


def test_make_block_mask_matches():
    rng = np.random.default_rng(31)
    rows = rng.integers(0, 300, 50).astype(np.int32)
    cols = rng.integers(0, 260, 50).astype(np.int32)
    valid = rng.random(50) < 0.8
    rows[~valid] = SENT
    got = t_bsr.make_block_mask(torch.from_numpy(rows), torch.from_numpy(cols),
                                torch.from_numpy(valid), 3, 3)
    want = j_bsr.make_block_mask(jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(valid), 3, 3)
    assert_same(got, want)


def test_run_offsets():
    pc = torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32)
    assert t_bsr.run_offsets(pc, 4).tolist() == [0, 2, 3, 3, 6]


# -- dispatch rules ------------------------------------------------------------------

def test_dispatch_follows_device_and_never_falls_back():
    rows = torch.zeros(8, dtype=torch.int32)
    assert cuda_lib.resolve_impl("auto", rows) == "ref"
    assert cuda_lib.resolve_impl("cuda", rows) == "cuda"
    with pytest.raises(ValueError, match="impl"):
        cuda_lib.resolve_impl("pallas", rows)
    # a CPU tensor handed to the kernel raises; it is not run on the plain
    # version instead
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_rm.range_mask(rows, rows, (0, 1, 0, 1), impl="cuda")
    a = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_sm.semiring_matmul(a, a, impl="cuda")
    tiles = torch.zeros((1, 128, 128))
    p = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_pairlist(tiles, tiles, p, p, p, n_c=1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_pairlist_reduce(tiles, tiles, p, p, p, n_o=1, axis=1,
                                  impl="cuda")
    # the block-masked kernels and the rank count raise on CPU tensors too,
    # instead of running the materializing plain version
    d = torch.zeros((128, 128))
    m = torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_spgemm_reduce(d, m, d, axis=1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_spgemm(d, m, d, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_rc.rank_count(p, p, impl="cuda")
    assert all(v == 0 for v in LAUNCHES.values())


def test_kernel_sources_present_and_hashed():
    """Every source the build compiles is in the package, and the library
    name follows the sources (an edit forces a rebuild)."""
    for name in cuda_lib.SOURCES + cuda_lib.HEADERS:
        assert (cuda_lib._CSRC / name).is_file(), name
    assert len(cuda_lib._digest()) == 16
    assert set(cuda_lib.SEMIRING_IDS) == set(SEMIRINGS)
