"""The hand-written CUDA kernels on the card, against their plain torch
versions, and the main path through them.  Every test skips without an
sm_90 card.  On the card (where JAX is not installed, so the repository's
conftest is left out):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are small integers or quarters, so every fp32 ⊕ is exact in any
order: kernel and plain version must agree exactly under every semiring.
"""
import numpy as np
import pytest
import torch

from repro_torch import main_path
from repro_torch.core import REGISTRY, spgemm
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
from repro_torch.kernels.range_extract.ops import range_mask_cuda
from repro_torch.kernels.range_extract.ref import range_mask_ref
from repro_torch.kernels.semiring_matmul.ops import semiring_matmul
from repro_torch.kernels.semiring_matmul.ref import semiring_matmul_ref
from repro_torch.kernels.sorted_merge import ops as rc_ops
from repro_torch.kernels.sorted_merge.ref import rank_count_ref

from _torch_helpers import SEMIRINGS, _reset_port_stats  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _vals(gen, shape, sr, card):
    v = torch.randint(1, 9, shape, generator=gen).float() / 4
    v[torch.rand(shape, generator=gen) < 0.3] = REGISTRY[sr].zero
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


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_semiring_matmul_kernel(card, sr):
    gen = torch.Generator().manual_seed(1)
    a = _vals(gen, (300, 200), sr, card)
    b = _vals(gen, (200, 130), sr, card)
    assert torch.equal(semiring_matmul(a, b, semiring=sr, impl="cuda"),
                       semiring_matmul_ref(a, b, semiring=sr))


def _pairs(gen, card, n_a=3, n_b=4, n_pairs=9, n_out=4):
    pa = torch.randint(0, n_a, (n_pairs,), generator=gen, dtype=torch.int32)
    pb = torch.randint(0, n_b, (n_pairs,), generator=gen, dtype=torch.int32)
    po = torch.sort(torch.cat([torch.arange(n_out), torch.randint(
        0, n_out, (n_pairs - n_out,), generator=gen)])).values.int()
    return [t.to(card) for t in (pa, pb, po)]


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_kernel(card, sr):
    gen = torch.Generator().manual_seed(2)
    at = _vals(gen, (3, 128, 128), sr, card)
    bt = _vals(gen, (4, 128, 128), sr, card)
    pa, pb, pc = _pairs(gen, card)
    got = bsr_ops.bsr_pairlist(at, bt, pa, pb, pc, n_c=4, semiring=sr)
    want = bsr_ref.bsr_pairlist_ref(at, bt, pa, pb, pc, n_c=4, semiring=sr)
    assert torch.equal(got, want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_reduce_kernel(card, sr, axis):
    gen = torch.Generator().manual_seed(3)
    at = _vals(gen, (3, 128, 128), sr, card)
    bt = _vals(gen, (4, 128, 128), sr, card)
    pa, pb, po = _pairs(gen, card)
    got = bsr_ops.bsr_pairlist_reduce(at, bt, pa, pb, po, n_o=4, axis=axis,
                                      semiring=sr)
    want = bsr_ref.bsr_pairlist_reduce_ref(at, bt, pa, pb, po, n_o=4,
                                           axis=axis, semiring=sr)
    assert torch.equal(got, want)


def _masked(gen, card, sr, m=256, k=384, n=256):
    """Block-masked operands: A's absent tiles hold values the kernel must
    skip; block-row 1 of the mask is empty (its output is the zero)."""
    a = _vals(gen, (m, k), sr, card)
    b = _vals(gen, (k, n), sr, card)
    mask = (torch.rand((m // 128, k // 128), generator=gen) < 0.6).int()
    mask[0, 0], mask[1] = 1, 0
    return a, mask.to(card), b


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_kernel(card, sr):
    a, mask, b = _masked(torch.Generator().manual_seed(4), card, sr)
    got = bsr_ops.bsr_spgemm(a, mask, b, semiring=sr)
    assert torch.equal(got, bsr_ref.bsr_spgemm_ref(a, mask, b, semiring=sr))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_reduce_kernel(card, sr, axis):
    a, mask, b = _masked(torch.Generator().manual_seed(5), card, sr)
    reset_launch_counts()
    got = bsr_ops.bsr_spgemm_reduce(a, mask, b, axis=axis, semiring=sr)
    assert LAUNCHES["bsr_spgemm_reduce"] == 1
    want = bsr_ref.bsr_spgemm_reduce_ref(a, mask, b, axis=axis, semiring=sr)
    assert torch.equal(got, want)


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
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_pairlist_rejects_bad_pairs(card):
    """Out-of-range tile indices or unsorted output ids raise before the
    kernel could read out of bounds."""
    t = torch.zeros((2, 128, 128), device=card)

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist(t, t, i32(0, 2), i32(0, 1), i32(0, 0), n_c=1)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist(t, t, i32(0, 1), i32(0, 1), i32(1, 0), n_c=2)
    with pytest.raises(ValueError, match="pair lists"):
        bsr_ops.bsr_pairlist_reduce(t, t, i32(0, 1), i32(0, 1), i32(0, 3),
                                    n_o=2, axis=1)
