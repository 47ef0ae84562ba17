"""The hand-written CUDA kernels on the card, against their plain torch
versions, and the main path through them.  Every test skips without an
sm_90 card.  On the card (where JAX is not installed, so the repository's
conftest is left out):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are small integers or quarters, so every fp32 ⊕ is exact in any
order: kernel and plain version must agree exactly under every semiring,
on both routes ((+, ×) on the TF32 tensor cores, the other five on the
CUDA cores).  Normal values hold the TF32 route within its stated bound
(``semiring_matmul.ref.tf32x3_error_bound``).
"""
import numpy as np
import pytest
import torch

from repro_torch import main_path
from repro_torch.core import REGISTRY, spgemm
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
from repro_torch.kernels.range_extract.ops import (range_mask_bytes,
                                                   range_mask_cuda)
from repro_torch.kernels.range_extract.ref import range_mask_ref
from repro_torch.kernels.semiring_matmul.ops import semiring_matmul
from repro_torch.kernels.semiring_matmul.ref import (nonfinite_operands,
                                                     semiring_matmul_ref,
                                                     tf32x3_error_bound)
from repro_torch.kernels.sorted_merge import ops as rc_ops
from repro_torch.kernels.sorted_merge.ref import rank_count_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (bf16_error_bound,
                                                     flash_attention_ref)
from repro_torch.models.attention import chunked_attention
from repro_torch.kernels.segment_reduce import ops as ss_ops
from repro_torch.kernels.segment_reduce.ref import (segment_scan_ref,
                                                    segment_scan_sum_bound,
                                                    segment_scan_tiled_ref)
from repro_torch.kernels.semiring_matmul.ref import ring_nonfinite_operands

from _torch_helpers import SEMIRINGS, _reset_port_stats  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _vals(gen, shape, sr, card, zeros=0.3):
    v = torch.randint(1, 9, shape, generator=gen).float() / 4
    v[torch.rand(shape, generator=gen) < zeros] = REGISTRY[sr].zero
    return v.to(card)


@pytest.mark.parametrize("n", [1, 5, 4096, 100003])
def test_range_mask_kernel(card, n):
    gen = torch.Generator().manual_seed(n)
    rows = torch.randint(0, 500, (n + 1,), generator=gen, dtype=torch.int32)
    cols = torch.randint(0, 500, (n + 1,), generator=gen, dtype=torch.int32)
    rows[::7] = 2 ** 31 - 1
    rows, cols = rows.to(card), cols.to(card)
    for r, c in ((rows[:n], cols[:n]), (rows[1:], cols[1:])):  # unaligned
        for b in [(0, 500, 0, 500), (10, 300, 50, 60), (7, 7, 0, 500)]:
            assert torch.equal(range_mask_cuda(r, c, b),
                               range_mask_ref(r, c, b))


SENT = 2 ** 31 - 1


def _sorted_coo(gen, n, n_rows=4000, n_cols=900, n_sent=0):
    """A canonical COO's (rows, cols): rows sorted, a sentinel tail."""
    rows = torch.sort(torch.randint(0, n_rows, (n,), generator=gen,
                                    dtype=torch.int32)).values
    cols = torch.randint(0, n_cols, (n,), generator=gen, dtype=torch.int32)
    if n_sent:
        rows[n - n_sent:] = SENT
    return rows, cols


def _one_warp_row(rows):
    """A row value of sorted rows whose run starts after and ends before a
    128-entry boundary (inside one warp's entries)."""
    v = torch.unique(rows[rows != SENT])
    start = torch.searchsorted(rows, v)
    end = torch.searchsorted(rows, v, right=True)
    ok = (end > start) & (start % 128 > 0) & (start // 128 == end // 128)
    return int(v[ok][0])


@pytest.mark.parametrize("case", ["run inside one warp", "run across warps",
                                  "no row inside", "every row inside",
                                  "sentinel tail", "unsorted",
                                  "n % 4 tails", "unaligned views"])
def test_range_mask_kernel_row_gated(card, case):
    """The row-gated kernel: cols are read only where an int4's rows meet
    the box, yet every entry equals the plain version, the box's run of a
    sorted COO starting and ending inside one warp's 128 entries or
    spanning many, no row or every row inside, sentinels, unsorted rows,
    tails of 1-3 entries and views that are not 16-byte aligned."""
    gen = torch.Generator().manual_seed(40)
    rows, cols = _sorted_coo(gen, 300000, n_sent=1000 if case ==
                             "sentinel tail" else 0)
    w = _one_warp_row(rows)
    boxes = {"run inside one warp": [(rows, cols, (w, w + 1, 0, 900)),
                                     (rows, cols, (w, w + 1, 300, 600))],
             "run across warps": [(rows, cols, (1000, 3000, 100, 800))],
             "no row inside": [(rows, cols, (4000, 5000, 0, 900)),
                               (rows, cols, (7, 7, 0, 900))],
             "every row inside": [(rows, cols, (0, 4000, 0, 900)),
                                  (rows, cols, (0, 4000, 450, 451))],
             "sentinel tail": [(rows, cols, (0, SENT, 0, 900)),
                               (rows, cols, (3990, SENT, 0, 900))],
             "unsorted": [(rows[p], cols[p], (1000, 3000, 0, 900))
                          for p in [torch.randperm(300000, generator=gen)]],
             "n % 4 tails": [(rows[:m], cols[:m], (int(rows[m // 2]), 4000,
                                                   0, 900))
                             for m in (1, 2, 3, 5, 6, 7, 299999)],
             "unaligned views": [(rows[o:], cols[o:], (500, 2500, 0, 900))
                                 for o in (1, 2, 3)]}[case]
    for r, c, b in boxes:
        r, c = r.to(card), c.to(card)
        reset_launch_counts()
        got = range_mask_cuda(r, c, b)
        assert LAUNCHES["range_mask"] == 1
        assert torch.equal(got, range_mask_ref(r, c, b)), (case, b)
    if case == "every row inside":
        assert range_mask_bytes(r, b) == 12 * r.shape[0]


# (M, K, N): the ring's and the TF32 route's edges — one 32-deep slab, one
# 128-wide k tile, M and N not multiples of 128, K not a multiple of 32
MATMUL_SHAPES = [(300, 200, 130), (128, 32, 128), (128, 128, 128),
                 (200, 70, 330), (129, 4099, 257)]


def _route_counts():
    return {k: LAUNCHES[k] for k in ("semiring_matmul", "semiring_matmul_tf32",
                                     "bsr_spgemm_reduce",
                                     "bsr_spgemm_reduce_tf32")}


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_semiring_matmul_kernel(card, sr, shape):
    m, k, n = shape
    gen = torch.Generator().manual_seed(1)
    a = _vals(gen, (m, k), sr, card)
    b = _vals(gen, (k, n), sr, card)
    reset_launch_counts()
    got = semiring_matmul(a, b, semiring=sr, impl="cuda")
    tf32 = int(sr == "plus_times")
    assert _route_counts() == {"semiring_matmul": 1,
                               "semiring_matmul_tf32": tf32,
                               "bsr_spgemm_reduce": 0,
                               "bsr_spgemm_reduce_tf32": 0}
    assert torch.equal(got, semiring_matmul_ref(a, b, semiring=sr))


def _normal(gen, shape, card):
    return torch.randn(shape, generator=gen).to(card)


@pytest.mark.parametrize("shape", [(256, 4096, 256), (129, 4099, 257),
                                   (128, 32, 128)])
def test_semiring_matmul_tf32_within_bound(card, shape):
    """Normal values: within the stated bound of the fp64 product, and a
    relative L2 error below 2^-16, which a product without the lo passes
    (about 2^-12) misses."""
    m, k, n = shape
    gen = torch.Generator().manual_seed(11)
    a, b = _normal(gen, (m, k), card), _normal(gen, (k, n), card)
    got = semiring_matmul(a, b, impl="cuda").double()
    want = a.double() @ b.double()
    assert bool(((got - want).abs() <= tf32x3_error_bound(a, b)).all())
    assert float((got - want).norm() / want.norm()) < 2 ** -16


def test_semiring_matmul_tf32_nonfinite(card):
    """±inf, NaN and overflow as in the plain version (inf, not NaN)."""
    a, b = nonfinite_operands(200, 300, 150, torch.Generator().manual_seed(12),
                              card)
    got = semiring_matmul(a, b, impl="cuda")
    want = semiring_matmul_ref(a, b)
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _pairs(gen, card, n_a=3, n_b=4, n_pairs=9, n_out=4):
    pa = torch.randint(0, n_a, (n_pairs,), generator=gen, dtype=torch.int32)
    pb = torch.randint(0, n_b, (n_pairs,), generator=gen, dtype=torch.int32)
    po = torch.sort(torch.cat([torch.arange(n_out), torch.randint(
        0, n_out, (n_pairs - n_out,), generator=gen)])).values.int()
    return [t.to(card) for t in (pa, pb, po)]


def _pair_counts():
    return {k: LAUNCHES[k] for k in ("bsr_pairlist", "bsr_pairlist_tf32",
                                     "bsr_pairlist_reduce",
                                     "bsr_pairlist_reduce_tf32")}


def _run_pairs(gen, card, lengths, n_a=5, n_b=6):
    """Pairs for outputs with runs of the given lengths (0: an empty run)."""
    n = sum(lengths)
    pa = torch.randint(0, n_a, (n,), generator=gen, dtype=torch.int32)
    pb = torch.randint(0, n_b, (n,), generator=gen, dtype=torch.int32)
    po = torch.repeat_interleave(torch.arange(len(lengths)),
                                 torch.tensor(lengths)).int()
    return [t.to(card) for t in (pa, pb, po)]


# runs of the pair kernels: one pair; the n=18 product's 1-4; a run longer
# than the reduce's chunk (95 pairs: six chunks) beside an empty run
PAIR_RUNS = {"one": [1], "short": [1, 4, 2, 3], "long": [95, 0, 17, 1]}


def _pair_tiles(gen, card, sr, runs):
    """Quarter-value tiles; the long runs' with 60% zeros, so that even the
    fused reduce's sums (95 · 128^3 products) stay below 2^20 and exact in
    any order."""
    z = 0.6 if runs == "long" else 0.3
    return (_vals(gen, (5, 128, 128), sr, card, z),
            _vals(gen, (6, 128, 128), sr, card, z))


@pytest.mark.parametrize("runs", list(PAIR_RUNS))
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_kernel(card, sr, runs):
    gen = torch.Generator().manual_seed(2)
    at, bt = _pair_tiles(gen, card, sr, runs)
    pa, pb, pc = _run_pairs(gen, card, PAIR_RUNS[runs])
    n_c = len(PAIR_RUNS[runs])
    reset_launch_counts()
    got = bsr_ops.bsr_pairlist(at, bt, pa, pb, pc, n_c=n_c, semiring=sr)
    tf32 = int(sr == "plus_times")
    assert _pair_counts() == {"bsr_pairlist": 1, "bsr_pairlist_tf32": tf32,
                              "bsr_pairlist_reduce": 0,
                              "bsr_pairlist_reduce_tf32": 0}
    want = bsr_ref.bsr_pairlist_ref(at, bt, pa, pb, pc, n_c=n_c, semiring=sr)
    assert torch.equal(got, want)


@pytest.mark.parametrize("runs", list(PAIR_RUNS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_reduce_kernel(card, sr, axis, runs):
    gen = torch.Generator().manual_seed(3)
    at, bt = _pair_tiles(gen, card, sr, runs)
    pa, pb, po = _run_pairs(gen, card, PAIR_RUNS[runs])
    n_o = len(PAIR_RUNS[runs])
    reset_launch_counts()
    got = bsr_ops.bsr_pairlist_reduce(at, bt, pa, pb, po, n_o=n_o, axis=axis,
                                      semiring=sr)
    tf32 = int(sr == "plus_times")
    assert _pair_counts() == {"bsr_pairlist": 0, "bsr_pairlist_tf32": 0,
                              "bsr_pairlist_reduce": 1,
                              "bsr_pairlist_reduce_tf32": tf32}
    want = bsr_ref.bsr_pairlist_reduce_ref(at, bt, pa, pb, po, n_o=n_o,
                                           axis=axis, semiring=sr)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_random_pairs(card, sr):
    """Pairs drawn at random, every output covered, both kernels."""
    gen = torch.Generator().manual_seed(9)
    at = _vals(gen, (3, 128, 128), sr, card)
    bt = _vals(gen, (4, 128, 128), sr, card)
    pa, pb, po = _pairs(gen, card)
    assert torch.equal(
        bsr_ops.bsr_pairlist(at, bt, pa, pb, po, n_c=4, semiring=sr),
        bsr_ref.bsr_pairlist_ref(at, bt, pa, pb, po, n_c=4, semiring=sr))
    for axis in (0, 1):
        assert torch.equal(
            bsr_ops.bsr_pairlist_reduce(at, bt, pa, pb, po, n_o=4, axis=axis,
                                        semiring=sr),
            bsr_ref.bsr_pairlist_reduce_ref(at, bt, pa, pb, po, n_o=4,
                                            axis=axis, semiring=sr))


def _pair_bound(at, bt, pa, pb, po, n_out):
    """The TF32 route's bound per output tile (the run as one product of
    its A tiles side by side and its B tiles stacked: K = 128 x pairs), and
    Σ_p |A_p|·|B_p| per output."""
    bound, mag = [], []
    for o in range(n_out):
        sel = (po == o).nonzero().flatten()
        if sel.numel() == 0:
            z = torch.zeros((128, 128), dtype=torch.float64, device=at.device)
            bound.append(z)
            mag.append(z)
            continue
        a = torch.cat([at[i] for i in pa[sel].tolist()], dim=1)
        b = torch.cat([bt[i] for i in pb[sel].tolist()], dim=0)
        bound.append(tf32x3_error_bound(a, b))
        mag.append(a.double().abs() @ b.double().abs())
    return torch.stack(bound), torch.stack(mag)


@pytest.mark.parametrize("runs", list(PAIR_RUNS))
def test_bsr_pairlist_tf32_within_bound(card, runs):
    """Normal values: each C tile within the stated bound of the fp64
    product, and a relative L2 error below 2^-16; each fused reduce within
    the bound plus its fp32 folds (2^-23 per term of the folded 128
    outputs, 2^-24 per chunk partial, each term at most Σ_j |A|·|B|)."""
    gen = torch.Generator().manual_seed(15)
    at, bt = _normal(gen, (5, 128, 128), card), _normal(gen, (6, 128, 128), card)
    pa, pb, po = _run_pairs(gen, card, PAIR_RUNS[runs])
    n = len(PAIR_RUNS[runs])
    got = bsr_ops.bsr_pairlist(at, bt, pa, pb, po, n_c=n).double()
    want = torch.zeros((n, 128, 128), dtype=torch.float64, device=card)
    want.index_add_(0, po.long(), torch.bmm(at[pa.long()].double(),
                                            bt[pb.long()].double()))
    bound, mag = _pair_bound(at, bt, pa, pb, po, n)
    assert bool(((got - want).abs() <= bound).all())
    assert float((got - want).norm() / want.norm()) < 2 ** -16
    chunks = torch.tensor([max(1, -(-r // bsr_ops.REDUCE_CHUNK))
                           for r in PAIR_RUNS[runs]], device=card)
    for axis in (0, 1):
        red = 2 if axis == 1 else 1
        got = bsr_ops.bsr_pairlist_reduce(at, bt, pa, pb, po, n_o=n,
                                          axis=axis).double()
        tol = bound.sum(red) + (128 * 2.0 ** -23 + (chunks[:, None] - 1)
                                * 2.0 ** -24) * mag.sum(red)
        assert bool(((got - want.sum(red)).abs() <= tol).all())


def _nonfinite_pairs(card, n_pairs=3):
    """nonfinite_operands cut into 128 x 128 tiles: one output tile from a
    run of n_pairs pairs (A's k tiles against B's)."""
    a, b = nonfinite_operands(128, 128 * n_pairs, 128,
                              torch.Generator().manual_seed(16), card)
    at = a.view(128, n_pairs, 128).transpose(0, 1).contiguous()
    bt = b.view(n_pairs, 128, 128).contiguous()
    idx = torch.arange(n_pairs, dtype=torch.int32, device=card)
    return a, b, at, bt, idx, torch.zeros_like(idx)


def test_bsr_pairlist_tf32_nonfinite(card):
    """±inf, NaN and overflow through the exact path, as in the plain
    version (the same sums in any order: nonfinite_operands)."""
    a, b, at, bt, idx, po = _nonfinite_pairs(card)
    want = semiring_matmul_ref(a, b)
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    got = bsr_ops.bsr_pairlist(at, bt, idx, idx, po, n_c=1)
    torch.testing.assert_close(got[0], want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, bsr_ref.bsr_pairlist_ref(
        at, bt, idx, idx, po, n_c=1), rtol=0, atol=0, equal_nan=True)
    for axis in (0, 1):
        got = bsr_ops.bsr_pairlist_reduce(at, bt, idx, idx, po, n_o=1,
                                          axis=axis)
        torch.testing.assert_close(got, bsr_ref.bsr_pairlist_reduce_ref(
            at, bt, idx, idx, po, n_o=1, axis=axis), rtol=0, atol=0,
            equal_nan=True)


def test_off_registry_semiring_raises_on_the_card(card):
    """A semiring that is not the registry's object has no kernel: the card
    routes raise before any launch; an mxu=True one takes the TF32 route."""
    import dataclasses
    t = torch.ones((1, 128, 128), device=card)
    i = torch.zeros(1, dtype=torch.int32, device=card)
    odd = dataclasses.replace(REGISTRY["min_plus"], mul=torch.mul)
    reset_launch_counts()
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        bsr_ops.bsr_pairlist(t, t, i, i, i, n_c=1, semiring=odd)
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        bsr_ops.bsr_pairlist_reduce(t, t, i, i, i, n_o=1, axis=1,
                                    semiring=odd)
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        semiring_matmul(t[0], t[0], semiring=odd, impl="cuda")
    one = torch.ones((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        bsr_ops.bsr_spgemm(t[0], one, t[0], semiring=odd)
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        bsr_ops.bsr_spgemm_reduce(t[0], one, t[0], axis=1, semiring=odd)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    dot = dataclasses.replace(REGISTRY["plus_times"], name="dot")
    got = bsr_ops.bsr_pairlist(t, t, i, i, i, n_c=1, semiring=dot)
    assert LAUNCHES["bsr_pairlist_tf32"] == 1
    assert bool((got == 128).all())
    got = bsr_ops.bsr_spgemm(t[0], one, t[0], semiring=dot)
    assert LAUNCHES["bsr_spgemm_tf32"] == 1
    assert bool((got == 128).all())


def _masked(gen, card, sr, m=256, k=384, n=256):
    """Block-masked operands: A's absent tiles hold values the kernel must
    skip; block-row 1 of the mask is empty (its output is the zero)."""
    a = _vals(gen, (m, k), sr, card)
    b = _vals(gen, (k, n), sr, card)
    mask = (torch.rand((m // 128, k // 128), generator=gen) < 0.6).int()
    mask[0, 0], mask[1] = 1, 0
    return a, mask.to(card), b


def _spgemm_counts():
    return {k: LAUNCHES[k] for k in ("bsr_spgemm", "bsr_spgemm_tf32",
                                     "bsr_spgemm_reduce",
                                     "bsr_spgemm_reduce_tf32")}


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_kernel(card, sr):
    """Exact under every semiring with an empty block-row; (+, ×) on the
    TF32 route (one bsr_spgemm_tf32 launch), the other five on the ring
    (none)."""
    a, mask, b = _masked(torch.Generator().manual_seed(4), card, sr)
    reset_launch_counts()
    got = bsr_ops.bsr_spgemm(a, mask, b, semiring=sr)
    assert _spgemm_counts() == {"bsr_spgemm": 1,
                                "bsr_spgemm_tf32": int(sr == "plus_times"),
                                "bsr_spgemm_reduce": 0,
                                "bsr_spgemm_reduce_tf32": 0}
    assert torch.equal(got, bsr_ref.bsr_spgemm_ref(a, mask, b, semiring=sr))


@pytest.mark.parametrize("shape", [(384, 4096, 256), (256, 384, 384)])
def test_bsr_spgemm_tf32_within_bound(card, shape):
    """Normal values under a mask with an empty block-row: within the
    stated bound with K = 128 x the block-row's present k tiles (the empty
    block-row exactly 0), and a relative L2 error below 2^-16."""
    m, k, n = shape
    gen = torch.Generator().manual_seed(17)
    a, b = _normal(gen, (m, k), card), _normal(gen, (k, n), card)
    mask = (torch.rand((m // 128, k // 128), generator=gen) < 0.5).int()
    mask[0, 0], mask[1] = 1, 0
    mask = mask.to(card)
    got = bsr_ops.bsr_spgemm(a, mask, b).double()
    full = torch.repeat_interleave(torch.repeat_interleave(mask, 128, 0),
                                   128, 1) != 0
    want = torch.where(full, a, 0.0).double() @ b.double()
    bound = bsr_ref.bsr_spgemm_tf32x3_error_bound(a, mask, b)
    assert bool(((got - want).abs() <= bound).all())
    assert not bool(got[128:256].any())
    assert float((got - want).norm() / want.norm()) < 2 ** -16


def test_bsr_spgemm_tf32_nonfinite(card):
    """±inf, NaN and entries above 2^62 in present and in absent tiles of
    A: the exact path over the present tiles gives the plain version's
    values (bsr_ref.masked_nonfinite_operands)."""
    a, mask, b = bsr_ref.masked_nonfinite_operands(
        256, 512, 256, torch.Generator().manual_seed(18), card)
    want = bsr_ref.bsr_spgemm_ref(a, mask, b)
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    reset_launch_counts()
    got = bsr_ops.bsr_spgemm(a, mask, b)
    assert LAUNCHES["bsr_spgemm_tf32"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bsr_spgemm_k0_is_the_empty_sum(card):
    """K = 0: (+, ×) gives zeros with no launch (the TF32 route has no
    product to run); a ring semiring launches and gives its zero."""
    a = torch.zeros((256, 0), device=card)
    b = torch.zeros((0, 128), device=card)
    mask = torch.zeros((2, 0), dtype=torch.int32, device=card)
    reset_launch_counts()
    got = bsr_ops.bsr_spgemm(a, mask, b)
    assert got.shape == (256, 128) and not bool(got.any())
    assert LAUNCHES["bsr_spgemm"] == 0
    got = bsr_ops.bsr_spgemm(a, mask, b, semiring="min_plus")
    assert bool((got == float("inf")).all())
    assert _spgemm_counts()["bsr_spgemm"] == 1


def _masked_case(gen, card, sr, case):
    """The fused reduce's edges: the 3 x 2 block mask with an empty
    block-row (_masked), one 128-wide k tile, and a block-row with one
    present k tile of six beside a full one and an empty one."""
    if case == "empty row":
        return _masked(gen, card, sr)
    if case == "one k tile":
        a, b = _vals(gen, (128, 128), sr, card), _vals(gen, (128, 128), sr, card)
        return a, torch.ones((1, 1), dtype=torch.int32, device=card), b
    a, _, b = _masked(gen, card, sr, m=384, k=768, n=256)
    mask = torch.zeros((3, 6), dtype=torch.int32)
    mask[0], mask[1, 4] = 1, 1
    return a, mask.to(card), b


@pytest.mark.parametrize("case", ["empty row", "one k tile", "one present"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_reduce_kernel(card, sr, axis, case):
    a, mask, b = _masked_case(torch.Generator().manual_seed(5), card, sr, case)
    reset_launch_counts()
    got = bsr_ops.bsr_spgemm_reduce(a, mask, b, axis=axis, semiring=sr)
    tf32 = int(sr == "plus_times")
    assert _route_counts() == {"semiring_matmul": 0,
                               "semiring_matmul_tf32": 0,
                               "bsr_spgemm_reduce": 1,
                               "bsr_spgemm_reduce_tf32": tf32}
    want = bsr_ref.bsr_spgemm_reduce_ref(a, mask, b, axis=axis, semiring=sr)
    assert torch.equal(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_bsr_spgemm_reduce_tf32_within_bound(card, axis):
    """Normal values under a mask with an empty block-row: each fold of the
    partials within the bound of the fp64 product (the fold's fp32 sums
    add 2^-23 per term of |C|'s row or column sum at most)."""
    gen = torch.Generator().manual_seed(13)
    a, b = _normal(gen, (384, 4096), card), _normal(gen, (4096, 256), card)
    mask = (torch.rand((3, 32), generator=gen) < 0.5).int()
    mask[1] = 0
    mask = mask.to(card)
    got = bsr_ops.bsr_spgemm_reduce(a, mask, b, axis=axis).double()
    full = torch.repeat_interleave(torch.repeat_interleave(mask, 128, 0),
                                   128, 1) != 0
    am = torch.where(full, a, 0.0)
    c = am.double() @ b.double()
    want = c.sum(axis)
    width = c.shape[axis]
    tol = (tf32x3_error_bound(am, b).sum(axis)
           + width * 2.0 ** -23 * c.abs().sum(axis))
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("axis", [0, 1])
def test_bsr_spgemm_reduce_tf32_nonfinite(card, axis):
    """±inf, NaN and overflow in the fused reduce as in the plain version."""
    a, b = nonfinite_operands(256, 384, 256, torch.Generator().manual_seed(14),
                              card)
    mask = torch.ones((2, 3), dtype=torch.int32, device=card)
    got = bsr_ops.bsr_spgemm_reduce(a, mask, b, axis=axis)
    want = bsr_ref.bsr_spgemm_reduce_ref(a, mask, b, axis=axis)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("ni,nj", [(1, 1), (5, 0), (300, 7), (4099, 70000)])
def test_rank_count_kernel(card, ni, nj):
    """Every entry, sentinels included, equals two searchsorted calls."""
    gen = torch.Generator().manual_seed(ni + nj)
    i = torch.sort(torch.randint(0, 5000, (ni,), generator=gen,
                                 dtype=torch.int32)).values
    j = torch.sort(torch.randint(0, 5000, (nj,), generator=gen,
                                 dtype=torch.int32)).values
    i[-(ni // 3):] = 2 ** 31 - 1
    j[nj - nj // 4:] = 2 ** 31 - 1
    i, j = i.to(card), j.to(card)
    for p, q in ((i, j), (j, i)):
        got, want = rc_ops.rank_count_cuda(p, q), rank_count_ref(p, q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ni,nj,vmax", [(50000, 7, 3), (7, 50000, 3),
                                        (20000, 30000, 20),
                                        (262144, 262144, 40000)])
def test_rank_count_kernel_long_runs(card, ni, nj, vmax):
    """Runs of equal values and sentinel tails longer than one block (2048
    merged elements), on both sides and in both tie orders."""
    gen = torch.Generator().manual_seed(ni * 3 + nj)
    i = torch.sort(torch.randint(0, vmax, (ni,), generator=gen,
                                 dtype=torch.int32)).values
    j = torch.sort(torch.randint(0, vmax, (nj,), generator=gen,
                                 dtype=torch.int32)).values
    i[ni - ni // 3:] = 2 ** 31 - 1
    j[nj - nj // 4:] = 2 ** 31 - 1
    i, j = i.to(card), j.to(card)
    for p, q in ((i, j), (j, i)):
        reset_launch_counts()
        got, want = rc_ops.rank_count_cuda(p, q), rank_count_ref(p, q)
        assert LAUNCHES["rank_count"] == 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rank_count_kernel_at_the_size_limit(card):
    """2^31 - 1 keys in all, the most the wrapper takes: the last block's
    slice end lies past the int32 range unless it is summed in 64 bits.
    i's entries above every j merge into that last block in both tie
    orders.  One key more is refused before any launch."""
    ni = 1000
    nj = 2 ** 31 - 1 - ni
    j = torch.arange(nj, dtype=torch.int32, device=card) // 8  # runs of 8
    top = nj // 8
    gen = torch.Generator().manual_seed(31)
    i = torch.cat([
        torch.randint(0, top, (600,), generator=gen, dtype=torch.int32),
        torch.full((100,), top - 1, dtype=torch.int32),
        torch.randint(top, 2 ** 30, (200,), generator=gen, dtype=torch.int32),
        torch.full((100,), 2 ** 31 - 1, dtype=torch.int32)])
    i = torch.sort(i).values.to(card)
    reset_launch_counts()
    got, want = rc_ops.rank_count_cuda(i, j), rank_count_ref(i, j)
    assert LAUNCHES["rank_count"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del j
    over = torch.zeros(1, dtype=torch.int32, device=card).expand(nj + 1)
    with pytest.raises(ValueError, match="2\\^31"):
        rc_ops.rank_count_cuda(i, over)
    assert LAUNCHES["rank_count"] == 1


def test_rank_count_sentinel_case(card):
    """The all-pairs Pallas path counts its own pad sentinels here; the
    kernel follows searchsorted: hit = [0, 1, 0, 4, 4]."""
    s = 2 ** 31 - 1
    i = torch.tensor([1, 3, 5, s, s], dtype=torch.int32, device=card)
    j = torch.tensor([3, 4, s, s, s, s], dtype=torch.int32, device=card)
    rank, hit = rc_ops.rank_count(i, j)
    assert rank.tolist() == [0, 0, 2, 2, 2] and hit.tolist() == [0, 1, 0, 4, 4]


def test_main_path_on_card_launches_every_kernel(card):
    """The small main path on the card goes through every kernel of the
    path and gives the CPU port's results."""
    reset_launch_counts()
    c = main_path.build_clustered(11, card)
    res = main_path.drive_clustered(c["A"], c["B"])
    u = main_path.build_uniform(8, card)
    res_u = main_path.drive_uniform(u["A"], u["B"])
    for k in ("range_mask", "bsr_pairlist", "bsr_pairlist_reduce",
              "semiring_matmul", "bsr_spgemm_reduce"):
        assert LAUNCHES[k] >= 1, LAUNCHES
    # PLUS_TIMES on the TF32 route, MIN_PLUS on the CUDA-core route
    assert LAUNCHES["semiring_matmul_tf32"] >= 1, LAUNCHES
    assert LAUNCHES["semiring_matmul"] > LAUNCHES["semiring_matmul_tf32"]
    assert LAUNCHES["bsr_spgemm_reduce_tf32"] >= 1, LAUNCHES
    assert LAUNCHES["bsr_pairlist_tf32"] >= 1, LAUNCHES
    assert LAUNCHES["bsr_pairlist_reduce_tf32"] >= 1, LAUNCHES
    for name, ok, detail in (main_path.check_clustered(c["raw"], res, True)
                             + main_path.check_uniform(u["raw"], res_u)):
        assert ok, (name, detail)


def test_ingest_path_on_card(card):
    """The small ingest path on the card: every snapshot equals the
    one-shot host oracle, and each merge launches rank_count twice."""
    built = main_path.build_ingest(9, card)
    reset_launch_counts()
    res = main_path.drive_ingest(built)
    merges = sum(r["stats"]["merges"] for r in res["per_aggregate"].values())
    assert merges == 6 and LAUNCHES["rank_count"] == 2 * merges
    for name, ok, detail in main_path.check_ingest(built["raw"], res):
        assert ok, (name, detail)


def test_dist_selection_on_card(card):
    """On a one-rank NCCL mesh a dist selection of three rank boxes, and an
    assignment through it, launch range_mask once a box and equal the same
    selection of the same shard on the CPU (the plain version)."""
    from repro_torch.core import AssocTensor, DistAssoc, Keys, make_mesh
    mesh = make_mesh(card)
    try:
        rng = np.random.default_rng(3)
        rows = np.char.zfill(rng.integers(0, 200, 5000).astype(str), 3)
        cols = np.char.zfill(rng.integers(0, 90, 5000).astype(str), 3)
        d = DistAssoc.from_triples(rows, cols, rng.integers(1, 9, 5000) * 1.0,
                                   mesh, aggregate="sum", device=card)
        rk = d.local.row_space.keys
        sel = (Keys(list(rk[10:20]) + list(rk[50:60]) + list(rk[100:105])),
               ":")
        loc = d.local
        plain = AssocTensor(loc.rows.cpu(), loc.cols.cpu(), loc.vals.cpu(),
                            loc.nnz.cpu(), loc.row_space, loc.col_space)
        reset_launch_counts()
        got = d[sel].local
        assert LAUNCHES["range_mask"] == 3
        want = plain._select_eager(sel)
        assert int(got.nnz) == int(want.nnz) > 0
        for f in ("rows", "cols", "vals"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
        d[sel] = 2.0
        assert LAUNCHES["range_mask"] == 6
        plain[sel] = 2.0
        assert torch.equal(d.local.vals.cpu(), plain.vals)
    finally:
        mesh.close()


def test_dense_matmul_reduce_on_card(card):
    """The dense strategy's fused reduce runs the block-masked kernel and
    equals the coo strategy and the host."""
    u = main_path.build_uniform(7, card)
    for axis in (0, 1):
        reset_launch_counts()
        got = spgemm.matmul_reduce(u["A"], u["B"], axis, impl="dense")
        assert LAUNCHES["bsr_spgemm_reduce"] == 1
        want = spgemm.matmul_reduce(u["A"], u["B"], axis, impl="coo")
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      u["A"].to_assoc().matmul_reduce(
                                          u["B"].to_assoc(), axis))


def test_empty_inputs_launch_nothing(card):
    """An empty size returns an empty result and counts no launch."""
    reset_launch_counts()
    t = torch.zeros((2, 128, 128), device=card)
    none = torch.zeros(0, dtype=torch.int32, device=card)
    assert bsr_ops.bsr_pairlist(t, t, none, none, none,
                                n_c=0).shape == (0, 128, 128)
    assert bsr_ops.bsr_pairlist_reduce(t, t, none, none, none, n_o=0,
                                       axis=1).shape == (0, 128)
    assert semiring_matmul(torch.zeros((0, 64), device=card),
                           torch.zeros((64, 5), device=card),
                           impl="cuda").shape == (0, 5)
    assert range_mask_cuda(none, none, (0, 1, 0, 1)).shape == (0,)
    empty = torch.zeros((0, 128), device=card)
    mask = torch.zeros((0, 1), dtype=torch.int32, device=card)
    assert bsr_ops.bsr_spgemm(empty, mask, t[0]).shape == (0, 128)
    assert bsr_ops.bsr_spgemm_reduce(empty, mask, t[0],
                                     axis=1).shape == (0,)
    assert rc_ops.rank_count_cuda(none, none)[0].shape == (0,)
    q = torch.ones((1, 2, 5, 64), dtype=torch.bfloat16, device=card)
    kv = torch.zeros((1, 1, 0, 64), dtype=torch.bfloat16, device=card)
    for dt in (torch.bfloat16, torch.float32):   # no key: every row is 0
        got = fa_ops.flash_attention_cuda(q.to(dt), kv.to(dt), kv.to(dt),
                                          causal=False)
        assert got.shape == q.shape and not bool(got.any())
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("host", [False, True])
def test_pairlist_rejects_bad_pairs(card, host):
    """Out-of-range tile indices or unsorted output ids raise before the
    kernel could read out of bounds: pair lists on the card (read back)
    and on the host (the planner's numpy arrays, checked there)."""
    t = torch.zeros((2, 128, 128), device=card)

    def i32(*x):
        if host:
            return np.array(x, np.int32)
        return torch.tensor(x, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist(t, t, i32(0, 2), i32(0, 1), i32(0, 0), n_c=1)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist(t, t, i32(0, 1), i32(0, 1), i32(1, 0), n_c=2)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist_reduce(t, t, i32(0, 1), i32(0, 1), i32(0, 3),
                                    n_o=2, axis=1)


# -- flash attention ----------------------------------------------------------------
# fp32: the kernel's products are exact and its sums fp32, so it differs from
# the plain version by summation order (3e-4, the JAX package's tolerance).
# bf16: an elementwise bound from the plain version (ref.bf16_error_bound):
# the rounding of P before P·V moves o_id by at most 2^-8·(P·|V|)_id, each
# output rounding by at most 2^-8·|o_id|.  It follows each row's own scale.
# Next to it, the relative L2 error stays below 2^-7: the roundings are each
# at most 2^-8 relative and do not all point one way.

def assert_flash_close(got, want, q, k, v, *, p_roundings=1, **masks):
    """``got`` against the plain ``want``, all [B,H,S,D]."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert float(err.max()) <= 3e-4, float(err.max())
        return
    bound = bf16_error_bound(q, k, v, want, p_roundings=p_roundings, **masks)
    assert bool((err <= bound).all()), float((err - bound).max())
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= 2 ** -7, rel


FLASH_CARD_CASES = [
    # b, h, kv, sq, sk, d, causal, window, q_off
    (2, 4, 2, 256, 256, 64, True, None, 0),
    (1, 4, 4, 512, 512, 32, True, 128, 0),
    (2, 2, 1, 256, 512, 64, False, None, 0),
    (1, 8, 8, 128, 128, 128, True, None, 0),
    (2, 4, 2, 100, 300, 48, True, None, 200),     # ragged, q_off > 0
    (1, 6, 3, 70, 70, 16, True, 33, 0),           # ragged, window
    (1, 2, 1, 64, 200, 80, False, None, 0),
    (4, 16, 8, 2048, 2048, 128, True, None, 0),   # the serve path's shape
    (1, 4, 2, 64, 96, 64, False, None, 0),        # Sk < 128
    (2, 4, 2, 300, 300, 128, True, None, 0),      # Sq, Sk not multiples of 128
    (1, 4, 2, 200, 333, 48, True, None, 133),     # D 48: zero-filled boxes
    (2, 4, 4, 257, 257, 80, True, 100, 0),        # D 80 across two boxes
    (1, 4, 2, 384, 384, 128, True, 200, 0),       # window edge inside a tile
    (2, 8, 2, 192, 640, 128, True, None, 448),    # q_off, Sq < Sk
    (1, 2, 1, 400, 100, 64, False, 16, 0),        # q tiles with no key tile
    (1, 32, 32, 512, 512, 112, True, None, 0),    # D 112 (zamba2-7b): TMA
    (2, 4, 4, 300, 300, 112, True, None, 0),      # zero-fills past D; ragged
    (1, 36, 36, 384, 384, 64, True, None, 0),     # D 64, MHA 36 (minicpm-2b)
    (1, 32, 2, 256, 256, 128, True, None, 0),     # GQA 16 (chatglm3-6b)
    (1, 36, 4, 256, 256, 128, True, None, 0),     # GQA 9 (starcoder2-7b)
    # GQA 6 with a window of 1024 (mixtral-8x22b's 48/8 heads, its 4096
    # window scaled down): rows whose first visible key is not tile-aligned,
    # tiles skipped below k_lo, fully masked first tiles for late rows
    (1, 12, 2, 1536, 1536, 128, True, 1024, 0),
    (2, 6, 1, 640, 1664, 128, True, 1024, 1024),  # the same, q_off > 0
    # whisper-medium (16/16 heads x 64, 1500 frames: no multiple of the
    # 128-key tile, so the last tile rests on TMA's zero fill and the Sk
    # mask): the encoder's self-attention, a decode step's cross-attention
    # (one query row in a 128-row box), the prefill's cross-attention
    (1, 16, 16, 1500, 1500, 64, False, None, 0),
    (4, 16, 16, 1, 1500, 64, False, None, 0),
    (1, 16, 16, 2048, 1500, 64, False, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FLASH_CARD_CASES)))
def test_flash_attention_kernel(card, case, dtype):
    b, h, kv, sq, sk, d, causal, window, q_off = FLASH_CARD_CASES[case]
    gen = torch.Generator().manual_seed(case)
    q = torch.randn((b, h, sq, d), generator=gen).to(card, dtype)
    k = torch.randn((b, kv, sk, d), generator=gen).to(card, dtype)
    v = torch.randn((b, kv, sk, d), generator=gen).to(card, dtype)
    kw = dict(causal=causal, window=window, q_off=q_off)
    reset_launch_counts()
    got = fa_ops.flash_attention_cuda(q, k, v, **kw)
    route = "flash_attention_wgmma" if dtype == torch.bfloat16 else \
        "flash_attention"
    assert fa_ops.kernel_route(dtype) == route
    assert LAUNCHES[route] == 1
    assert LAUNCHES["flash_attention"] + LAUNCHES["flash_attention_wgmma"] == 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert_flash_close(got, want, q, k, v, **kw)


# MLA's prefill: q/k head dim 192 (qk_nope 128 + qk_rope 64), v head dim
# 128, MHA, scale 1/sqrt(192); a chunk after the first attends at q_off =
# the cursor over cursor + chunk keys
FLASH_MLA_CASES = [
    # b, h, sq, sk, q_off
    (2, 4, 256, 256, 0),
    (2, 4, 256, 512, 256),       # the second of two 256-token chunks
    (1, 8, 200, 333, 133),       # ragged: Sq, Sk not multiples of 128
    (1, 2, 64, 1024, 960),       # one q tile over eight key tiles
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FLASH_MLA_CASES)))
def test_flash_attention_kernel_mla_head_dims(card, case, dtype):
    b, h, sq, sk, q_off = FLASH_MLA_CASES[case]
    gen = torch.Generator().manual_seed(100 + case)
    q = torch.randn((b, h, sq, 192), generator=gen).to(card, dtype)
    k = torch.randn((b, h, sk, 192), generator=gen).to(card, dtype)
    v = torch.randn((b, h, sk, 128), generator=gen).to(card, dtype)
    kw = dict(causal=True, q_off=q_off, sm_scale=192 ** -0.5)
    reset_launch_counts()
    got = fa_ops.flash_attention_cuda(q, k, v, **kw)
    assert LAUNCHES[fa_ops.kernel_route(dtype)] == 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == (b, h, sq, 128)
    assert_flash_close(got, want, q, k, v, **kw)


def test_flash_attention_rejects_pairs_it_has_no_instance_for(card):
    q = torch.zeros((1, 2, 64, 128), device=card, dtype=torch.bfloat16)
    v = torch.zeros((1, 2, 64, 64), device=card, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="q/k 128, v 64"):
        fa_ops.flash_attention_cuda(q, q, v)
    assert LAUNCHES["flash_attention_wgmma"] == 0


def test_flash_attention_model_layout_on_card(card):
    """[B,S,H,D] views go in and out without copies; "auto" launches the
    kernel on CUDA tensors; decode (k_valid_len) takes the plain path."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 192, 8, 64), generator=gen).to(card, torch.bfloat16)
    k = torch.randn((2, 192, 2, 64), generator=gen).to(card, torch.bfloat16)
    v = torch.randn((2, 192, 2, 64), generator=gen).to(card, torch.bfloat16)
    reset_launch_counts()
    got = fa_ops.flash_attention(q, k, v, causal=True, impl="auto")
    assert LAUNCHES["flash_attention_wgmma"] == 1 and got.shape == q.shape
    want = fa_ops.flash_attention(q, k, v, causal=True, impl="ref")
    assert_flash_close(*(x.transpose(1, 2) for x in (got, want, q, k, v)),
                       causal=True)
    chunked_attention(q[:, :1], k, v, k_valid_len=torch.tensor(5, device=card),
                      q_positions=torch.tensor([4], device=card),
                      k_positions=torch.arange(192, device=card), causal=True,
                      impl="cuda")
    assert LAUNCHES["flash_attention_wgmma"] == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), impl="cuda")


def test_serve_path_on_card(card):
    """The SMOKE qwen3 served on the card: one flash launch per layer in
    the prefill (bf16: the wgmma route), none in decode, and the kernel route's logits within
    bf16 rounding of the plain route's."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve as TSV
    from repro_torch.models import model as TM
    cfg = get_smoke("qwen3-1.7b")
    params = TM.init(TM.make_generator(0, card), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 64), device=card,
                            dtype=torch.int32)
    reset_launch_counts()
    res = TSV.serve(params, cfg, prompts, 4)
    assert LAUNCHES["flash_attention_wgmma"] == cfg.n_layers
    assert LAUNCHES["flash_attention"] == 0
    assert res["tokens"].shape == (2, 4)
    plain = TSV.serve(params, cfg.replace(attn_impl="ref"), prompts, 4)
    want = plain["prefill_logits"]
    err = float((res["prefill_logits"] - want).abs().max())
    assert err <= 2 ** -5 * float(want.abs().max()), err


# starcoder2-7b's SMOKE head dim is 12, below the kernel's multiple of 16;
# chip_smoke.py serves it at full width (D 128)
@pytest.mark.parametrize("arch", ["chatglm3-6b", "minicpm-2b", "chameleon-34b",
                                  "mamba2-130m", "zamba2-7b"])
def test_families_serve_path_on_card(card, arch):
    """The SMOKE configs of module step 9a served on the card: one flash
    launch per attention layer or shared-block invocation in the prefill
    (bf16: the wgmma route), none for mamba2, and the kernel route's
    logits within bf16 rounding of the plain route's (relative L2 2^-4,
    the bound chip_smoke.py uses)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve as TSV
    from repro_torch.models import model as TM
    cfg = get_smoke(arch)
    params = TM.init(TM.make_generator(0, card), cfg)
    if "shared_lora" in params:
        params["shared_lora"]["b"].normal_()
    prompts = torch.randint(0, cfg.vocab, (2, 64), device=card,
                            dtype=torch.int32)
    reset_launch_counts()
    res = TSV.serve(params, cfg, prompts, 4)
    want_launches = {"dense": cfg.n_layers, "ssm": 0,
                     "hybrid": -(-cfg.n_layers // (cfg.hybrid or {}).get(
                         "attn_every", 1))}[cfg.family]
    assert LAUNCHES["flash_attention_wgmma"] == want_launches
    assert LAUNCHES["flash_attention"] == 0
    assert res["tokens"].shape == (2, 4)
    plain = TSV.serve(params, cfg.replace(attn_impl="ref"), prompts, 4)
    got, want = res["prefill_logits"], plain["prefill_logits"]
    assert float((got - want).norm() / want.norm()) <= 2 ** -4


def test_mixtral_serve_path_on_card(card):
    """mixtral-8x22b's SMOKE config (window 64, 4 experts top-2) served on
    the card with a prompt of 96 tokens, past its window: one windowed
    flash launch per layer in the prefill, a ring cache of 64 slots
    carried through the repack, and the kernel route's logits within bf16
    rounding of the plain route's (relative L2 2^-4)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve as TSV
    from repro_torch.models import model as TM
    cfg = get_smoke("mixtral-8x22b")
    params = TM.init(TM.make_generator(0, card), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 96), device=card,
                            dtype=torch.int32)
    reset_launch_counts()
    res = TSV.serve(params, cfg, prompts, 4)
    assert LAUNCHES["flash_attention_wgmma"] == cfg.n_layers
    assert LAUNCHES["flash_attention"] == 0
    assert res["tokens"].shape == (2, 4)
    cache = res["cache"]["moe_stack"]
    assert cache["k"].shape[2] == cfg.window
    assert cache["len"].tolist() == [100] * cfg.n_layers
    plain = TSV.serve(params, cfg.replace(attn_impl="ref"), prompts, 4)
    got, want = res["prefill_logits"], plain["prefill_logits"]
    assert float((got - want).norm() / want.norm()) <= 2 ** -4


# -- segment scan -------------------------------------------------------------------

def _runs(gen, n, max_run, card, quarters):
    lengths = torch.randint(1, max_run + 1, (n,), generator=gen)
    keys = torch.repeat_interleave(torch.arange(n), lengths)[:n] * 5 - 7
    vals = (torch.randint(1, 9, (n,), generator=gen).float() / 4 if quarters
            else torch.randn(n, generator=gen))
    return keys.to(card, torch.int32), vals.to(card)


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
@pytest.mark.parametrize("n,max_run", [(1, 1), (5, 3), (256, 40),
                                       (1000, 600), (4097, 2000),
                                       (300000, 5000), (2 ** 21, 4)])
def test_segment_scan_kernel(card, n, max_run, combine):
    """min/max exact; sums exact on quarter values (every partial sum is
    a multiple of 1/4 below 2^20).  On normal values each version's
    rounding error is at most γ_d(i) · Σ|v| over the run so far, d(i) its
    summation depth (the kernel's from its order model, the plain
    version's from its doubling): ``segment_scan_sum_bound``.  The kernel
    equals its order model in every bit."""
    gen = torch.Generator().manual_seed(n)
    for quarters in (True, False):
        keys, vals = _runs(gen, n, max_run, card, quarters)
        reset_launch_counts()
        got = ss_ops.segment_scan(keys, vals, combine=combine, impl="cuda")
        assert LAUNCHES["segment_scan"] == 1
        want = segment_scan_ref(keys, vals, combine=combine)
        if combine != "sum" or quarters:
            assert torch.equal(got, want)
        else:
            tol = segment_scan_sum_bound(keys, vals)
            assert bool(((got.double() - want.double()).abs() <= tol).all())
        kp, vp = ss_ops.pad_for_kernel(keys, vals)
        assert torch.equal(got, segment_scan_tiled_ref(
            kp, vp, combine=combine)[:n])


def test_segment_scan_empty_and_aggregate(card):
    none = torch.zeros(0, dtype=torch.int32, device=card)
    reset_launch_counts()
    assert ss_ops.segment_scan(none, none.float(), impl="cuda").shape == (0,)
    assert ss_ops.segment_scan_cuda(none, none.float()).shape == (0,)
    assert LAUNCHES["segment_scan"] == 0
    keys = torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32, device=card)
    vals = torch.tensor([1., 2., 5., 1., 1., 1.], device=card)
    _, v, heads = ss_ops.aggregate_runs(keys, vals)       # auto: the kernel
    assert LAUNCHES["segment_scan"] == 1
    assert v.tolist() == [3.0, 0.0, 5.0, 3.0, 0.0, 0.0]
    assert heads.tolist() == [True, False, True, True, False, False]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss_ops.segment_scan(keys.cpu(), vals.cpu(), impl="cuda")


def _few_runs(gen, n, max_run, card):
    """Sorted keys in runs of 1..max_run (drawn only as many as n needs)
    and normal values."""
    count = 2 * n // (max_run + 1) + 10
    lengths = torch.randint(1, max_run + 1, (count,), generator=gen)
    while int(lengths.sum()) < n:
        lengths = torch.cat([lengths, torch.randint(1, max_run + 1, (10,),
                                                    generator=gen)])
    keys = torch.repeat_interleave(torch.arange(lengths.shape[0]),
                                   lengths)[:n] * 5 - 7
    return keys.to(card, torch.int32), torch.randn(n, generator=gen).to(card)


def _assert_same_bits(got, want):
    """Equal values (−0 = +0), NaN exactly where NaN."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])


# (n, max_run): the clustered pair ids' short runs, runs of thousands
# across tiles, one run over every tile (beyond 32 and 1024 tiles: the
# look-back's second and third levels), and 2^24 elements
SCAN_MODEL_CASES = [(4096, 3), (2 ** 21, 4), (300000, 5000),
                    (33 * 4096 + 5, 33 * 4096 + 5), (2 ** 21, 2 ** 21),
                    (1025 * 4096, 1025 * 4096), (2 ** 24, 6)]


@pytest.mark.parametrize("n,max_run", SCAN_MODEL_CASES)
def test_segment_scan_equals_its_order_model(card, n, max_run):
    """Every bit of the kernel equals segment_scan_tiled_ref under sum, min
    and max, on normal values with NaN, +inf and -inf among them; sums of
    normal values within γ_d(i)·Σ|v| of the fp64 scan."""
    gen = torch.Generator().manual_seed(n + max_run)
    keys, vals = _few_runs(gen, n, max_run, card)
    specials = vals.clone()
    at = torch.randint(0, n, (6,), generator=gen).to(card)
    specials[at] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 float("nan"), float("inf"), 1.0],
                                device=card)
    for combine in ("sum", "min", "max"):
        for v in (vals, specials):
            got = ss_ops.segment_scan_cuda(keys, v, combine=combine)
            _assert_same_bits(got, segment_scan_tiled_ref(keys, v,
                                                          combine=combine))
    got = ss_ops.segment_scan_cuda(keys, vals).double()
    bound = segment_scan_sum_bound(keys, vals, against="exact")
    # the scan in fp64 (the plain doubling); its own rounding, about
    # 2^-48·Σ|v|, is far below 2^-20 of the bound wherever d(i) >= 1, and
    # an element with d(i) = 0 is its own value in both
    exact = vals.double()
    step = 1
    while step < n:
        same = keys[step:] == keys[:-step]
        exact[step:] = torch.where(same, exact[:-step] + exact[step:],
                                   exact[step:])
        step *= 2
    assert bool(((got - exact).abs() <= bound * (1 + 2 ** -20)).all())


def test_segment_scan_reuses_its_scratch(card):
    """Calls with different data on one stream share one buffer of status
    words: the second reads no word of the first (each word carries its
    call's epoch), and a call on the same data gives the same bits."""
    gen = torch.Generator().manual_seed(5)
    n = 300 * 4096 + 17
    k1, v1 = _few_runs(gen, n, n, card)     # one run
    k2, v2 = _few_runs(gen, n, 3, card)     # short runs
    first = ss_ops.segment_scan_cuda(k1, v1)
    key = (k1.device, torch.cuda.current_stream(card).cuda_stream)
    status, epoch = ss_ops._status[key]
    again = ss_ops.segment_scan_cuda(k2, v2)
    assert torch.equal(again, segment_scan_tiled_ref(k2, v2))
    third = ss_ops.segment_scan_cuda(k1, v1)
    assert ss_ops._status[key][0] is status
    assert ss_ops._status[key][1] == epoch + 2
    assert torch.equal(first, third)
    assert torch.equal(first, segment_scan_tiled_ref(k1, v1))


def test_segment_scan_status_words_start_clean(card):
    """A new stream's status words take memory that held forged words: the
    epochs of its first calls with the head bit set (the int32 pairs 2·epoch
    + 1 and a huge value).  The buffer is zeroed when it is made, so one run
    over 1025 tiles (every tile looks back, three levels) comes out equal
    to its order model in both calls."""
    gen = torch.Generator().manual_seed(8)
    n = 1025 * 4096
    keys, vals = _few_runs(gen, n, n, card)
    want = segment_scan_tiled_ref(keys, vals)
    words = ss_ops.scratch_words(n)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        forged = torch.empty((words, 2), dtype=torch.int32, device=card)
        forged[:, 0] = torch.tensor([1e30]).view(torch.int32).item()
        forged[0::2, 1] = 2 * 1 + 1     # epoch 1, a head
        forged[1::2, 1] = 2 * 2 + 1     # epoch 2, a head
        where = forged.data_ptr()
        del forged
        got = [ss_ops.segment_scan_cuda(keys, vals) for _ in range(2)]
        status = ss_ops._status[(keys.device, stream.cuda_stream)][0]
    torch.cuda.synchronize()
    assert status.data_ptr() == where   # the forged words' memory
    for g in got:
        assert torch.equal(g, want)
    del ss_ops._status[(keys.device, stream.cuda_stream)]


def test_segment_scan_is_one_kernel(card):
    """One call runs exactly one device kernel (no memset, no second
    pass), counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(6)
    keys, vals = _few_runs(gen, 2 ** 21, 4, card)
    ss_ops.segment_scan_cuda(keys, vals)   # built, loaded, status words made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ss_ops.segment_scan_cuda(keys, vals, combine="max")
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in kernels]
    assert len(kernels) == 1 and "segment_scan" in names[0], names


# -- NaN and opposite infinities under the ring semirings -----------------------------

RING = [s for s in SEMIRINGS if s != "plus_times"]


@pytest.mark.parametrize("sr", RING)
def test_ring_kernels_propagate_nan(card, sr):
    """semiring_matmul, bsr_spgemm, bsr_spgemm_reduce and both pair
    kernels on NaN and opposite infinities (ring_nonfinite_operands; for
    the masked kernels B's non-finite rows in a k tile present in every
    block-row): equal to the plain versions, NaN where they have NaN."""
    gen = torch.Generator().manual_seed(19)
    a, b = ring_nonfinite_operands(256, 512, 256, gen, card)
    got = semiring_matmul(a, b, semiring=sr, impl="cuda")
    want = semiring_matmul_ref(a, b, semiring=sr)
    assert bool(torch.isnan(want[3]).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    ma, mask, mb = bsr_ref.masked_ring_nonfinite_operands(256, 512, 256, gen,
                                                         card)
    torch.testing.assert_close(
        bsr_ops.bsr_spgemm(ma, mask, mb, semiring=sr),
        bsr_ref.bsr_spgemm_ref(ma, mask, mb, semiring=sr),
        rtol=0, atol=0, equal_nan=True)
    for axis in (0, 1):
        torch.testing.assert_close(
            bsr_ops.bsr_spgemm_reduce(ma, mask, mb, axis=axis, semiring=sr),
            bsr_ref.bsr_spgemm_reduce_ref(ma, mask, mb, axis=axis,
                                          semiring=sr),
            rtol=0, atol=0, equal_nan=True)
    # the pair kernels: A @ B as a pair list of 128 x 128 tiles
    at = a.view(2, 128, 4, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    bt = b.view(4, 128, 2, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    i, j, kk = torch.meshgrid(torch.arange(2), torch.arange(2),
                              torch.arange(4), indexing="ij")
    pa, pb, pc = ((x.reshape(-1).int()).to(card) for x in
                  (i * 4 + kk, kk * 2 + j, i * 2 + j))
    at, bt = at.contiguous(), bt.contiguous()
    got = bsr_ops.bsr_pairlist(at, bt, pa, pb, pc, n_c=4, semiring=sr)
    torch.testing.assert_close(got, bsr_ref.bsr_pairlist_ref(
        at, bt, pa, pb, pc, n_c=4, semiring=sr), rtol=0, atol=0,
        equal_nan=True)
    tiles = want.view(2, 128, 2, 128).permute(0, 2, 1, 3).reshape(4, 128, 128)
    torch.testing.assert_close(got, tiles, rtol=0, atol=0, equal_nan=True)
    po = (i.reshape(-1).int()).to(card)        # block-row i: one output each
    for axis in (0, 1):
        torch.testing.assert_close(
            bsr_ops.bsr_pairlist_reduce(at, bt, pa, pb, po, n_o=2,
                                        axis=axis, semiring=sr),
            bsr_ref.bsr_pairlist_reduce_ref(at, bt, pa, pb, po, n_o=2,
                                            axis=axis, semiring=sr),
            rtol=0, atol=0, equal_nan=True)


@pytest.fixture
def nccl_mesh(card):
    from repro_torch.core import make_mesh
    mesh = make_mesh(card)
    yield mesh
    mesh.close()


def test_dist_matmul_on_nccl(nccl_mesh, card):
    """On a one-rank NCCL mesh: the replicate strategy's tiled product
    launches ``bsr_pairlist`` and equals the same product through the plain
    pair list (``kernel_impl="ref"``); the forced ``all_to_all`` (one NCCL
    all_to_all) equals the host ``Assoc``.  Integer values: exact."""
    from repro_torch.core import Assoc, DistAssoc, MIN_PLUS
    rng = np.random.default_rng(5)
    ar = np.char.zfill(rng.integers(0, 300, 3000).astype(str), 3)
    ac = np.char.zfill(rng.integers(0, 200, 3000).astype(str), 3)
    br = np.char.zfill(rng.integers(0, 200, 3000).astype(str), 3)
    bc = np.char.zfill(rng.integers(0, 250, 3000).astype(str), 3)
    av = rng.integers(1, 5, 3000).astype(np.float64)
    bv = rng.integers(1, 5, 3000).astype(np.float64)
    a = DistAssoc.from_triples(ar, ac, av, nccl_mesh, aggregate="sum",
                               device=card)
    b = DistAssoc.from_triples(br, bc, bv, nccl_mesh, aggregate="sum",
                               device=card)
    ha = Assoc(ar, ac, av, aggregate="sum")
    hb = Assoc(br, bc, bv, aggregate="sum")
    for sr in ("plus_times", MIN_PLUS):
        reset_launch_counts()
        got = a.matmul(b, sr, impl="bsr")
        assert LAUNCHES["bsr_pairlist"] >= 1
        ref = a.matmul(b, sr, impl="bsr", kernel_impl="ref")
        for f in ("rows", "cols", "vals", "nnz"):
            assert torch.equal(getattr(got.local, f), getattr(ref.local, f))
        assert got.to_assoc() == ha.matmul(hb, sr)
        a2a = a.matmul(b, sr, impl="all_to_all")
        assert a2a.local.rows.is_cuda
        assert a2a.to_assoc() == ha.matmul(hb, sr)


def test_contracts_hold_on_the_card(nccl_mesh, card):
    """Every ``@contract``'s programs on the card (the dist ones on a
    one-rank NCCL mesh), with ``impl="auto"``: no violation — host reads
    counted with device-to-host copies, peak memory within the budget —
    and the probes launch range_mask, both pair kernels and rank_count."""
    from repro_torch.analysis import verify_all
    reset_launch_counts()
    res = verify_all(device="cuda", mesh=nccl_mesh)
    bad = {k: [str(v) for v in vs] for k, vs in res.items() if vs}
    assert not bad, bad
    for k in ("range_mask", "bsr_pairlist", "bsr_pairlist_reduce",
              "rank_count"):
        assert LAUNCHES[k] >= 1, k


def test_serve_device_table_over_http_on_card(card):
    """Device tables on the card served over loopback HTTP: the fused
    select→product→reduce launches range_mask (the selection's rank box)
    and the pair-list reduce, and the served vector equals the in-process
    ``collect()`` of the same query; the served product's triples equal
    the host ``Assoc`` (values 1.0: exact)."""
    from repro_torch.core import Assoc, Keys
    from repro_torch.serve import (D4MClient, TableRef, TableRegistry,
                                   from_wire, start_server, to_wire)
    c = main_path.build_clustered(14, card)
    reg = TableRegistry(card)
    reg.register("edges", c["A"])
    reg.register("feat", c["B"])
    sel = main_path.row_range(c["A"])
    E, F = TableRef("edges"), TableRef("feat")
    pipe = to_wire((E[sel, :] @ F).sum(axis=1))
    keys = list(main_path._serve_windows(c["A"], c["B"], 1)[0])
    prod = to_wire(E[Keys(keys), :] @ F)
    srv = start_server(reg, workers=2)
    try:
        client = D4MClient(srv.url)
        reset_launch_counts()
        got = client.query(pipe)["result"]
        pipe_launches = dict(LAUNCHES)
        reset_launch_counts()
        got_prod = client.query(prod)["result"]
        prod_launches = dict(LAUNCHES)
    finally:
        srv.close()
    assert pipe_launches["range_mask"] >= 1
    assert pipe_launches["bsr_pairlist_reduce"] >= 1
    assert prod_launches["range_mask"] >= 1
    assert prod_launches["bsr_pairlist"] >= 1
    want = from_wire(pipe, resolve=reg.resolve).collect()
    assert got["vals"] == want.double().cpu().tolist()
    rows, cols, rows2, cols2 = c["raw"]
    host = Assoc(rows, cols, 1.0)[Keys(keys), :] @ Assoc(rows2, cols2, 1.0)
    r, cc, v = host.triples()
    assert got_prod["nnz"] == len(r) > 0
    assert sorted(zip(got_prod["rows"], got_prod["cols"], got_prod["vals"])) \
        == sorted(zip(r.tolist(), cc.tolist(), v.tolist()))
