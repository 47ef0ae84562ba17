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


def test_main_path_on_card_launches_every_kernel(card):
    """The small main path on the card goes through all four kernels and
    gives the CPU port's results."""
    reset_launch_counts()
    c = main_path.build_clustered(11, card)
    res = main_path.drive_clustered(c["A"], c["B"])
    u = main_path.build_uniform(8, card)
    res_u = main_path.drive_uniform(u["A"], u["B"])
    assert all(v >= 1 for v in LAUNCHES.values()), LAUNCHES
    for name, ok, detail in (main_path.check_clustered(c["raw"], res, True)
                             + main_path.check_uniform(u["raw"], res_u)):
        assert ok, (name, detail)


def test_dense_matmul_reduce_raises_on_card(card):
    u = main_path.build_uniform(7, card)
    with pytest.raises(NotImplementedError, match="bsr_spgemm_reduce"):
        spgemm.matmul_reduce(u["A"], u["B"], 1, impl="dense")
    got = spgemm.matmul_reduce(u["A"], u["B"], 1, impl="bsr")
    want = spgemm.matmul_reduce(u["A"], u["B"], 1, impl="coo")
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  u["A"].to_assoc().matmul_reduce(
                                      u["B"].to_assoc(), 1))


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
