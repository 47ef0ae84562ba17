"""NaN and opposite infinities under the five ring semirings (max or min
for ⊕): the port's plain versions against the JAX package's Pallas kernels
in interpret mode, which propagate NaN through ``jnp.maximum`` and
``jnp.minimum``.  The card's kernels are held to the same plain versions
in ``test_torch_cuda.py`` (their ⊕ is PTX ``max.NaN`` / ``min.NaN``).

The operands (``ring_nonfinite_operands``) make a NaN row and column of C,
NaN where +inf meets −inf or an inf meets 0, and −inf or +inf elsewhere;
every result is a max or min of terms that are the same in any order, so
the tolerance is 0, with NaN equal to NaN.  The block-masked kernels skip
absent tiles, as the Pallas kernels do, while the plain versions ⊗ the
semiring zero, so B's non-finite rows lie in a k tile present in every
block-row (``masked_ring_nonfinite_operands``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import ops as j_bsr
from repro.kernels.semiring_matmul import ops as j_sm
from repro_torch.kernels.bsr_spgemm import ref as t_bsr_ref
from repro_torch.kernels.semiring_matmul.ref import (ring_nonfinite_operands,
                                                     semiring_matmul_ref)

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401

RING = ("max_plus", "min_plus", "max_min", "max_times", "and_or")
M, K, N = 128, 256, 128


def assert_equal_nan(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)      # NaN equals NaN here


def operands(seed, m=M):
    a, b = ring_nonfinite_operands(m, K, N, torch.Generator().manual_seed(seed),
                                   "cpu")
    return a, b


def tiles_of(a, b):
    """A and B cut into 128 x 128 tiles, and the pair list of A @ B:
    C tile (i, j) from the pairs (i, kk) x (kk, j), grouped by C tile."""
    mi, nk, nj = a.shape[0] // 128, a.shape[1] // 128, b.shape[1] // 128
    at = a.view(mi, 128, nk, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    bt = b.view(nk, 128, nj, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    i, j, kk = np.meshgrid(np.arange(mi), np.arange(nj), np.arange(nk),
                           indexing="ij")
    pa = (i * nk + kk).reshape(-1).astype(np.int32)
    pb = (kk * nj + j).reshape(-1).astype(np.int32)
    pc = (i * nj + j).reshape(-1).astype(np.int32)
    return at.contiguous(), bt.contiguous(), pa, pb, pc, mi * nj


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles):
    """The Pallas bodies (interpret mode) of the tests below, run first on
    threads so that their programs compile side by side; each test then
    makes the same calls."""
    P = functools.partial

    def jnp_of(*xs):
        return [jnp.asarray(x.numpy() if torch.is_tensor(x) else x)
                for x in xs]

    a, b = jnp_of(*operands(1))
    masked = [jnp_of(*t_bsr_ref.masked_ring_nonfinite_operands(
        256, K, N, torch.Generator().manual_seed(seed), "cpu"))
        for seed in (2, 3)]
    *pairs, n_c = tiles_of(*operands(4))
    at, bt, pa, pb, pc = jnp_of(*pairs)
    rt, rb, ra, rpb, rpc, _ = tiles_of(*operands(5))
    red = jnp_of(rt, rb, ra, rpb, np.zeros_like(rpc))
    calls = []
    for sr in RING:
        calls += [P(j_sm.semiring_matmul, a, b, semiring=sr,
                    impl="interpret"),
                  P(j_bsr.bsr_spgemm, *masked[0], semiring=sr,
                    impl="interpret"),
                  P(j_bsr.bsr_pairlist, at, bt, pa, pb, pc, n_c=n_c,
                    semiring=sr, impl="interpret")]
        calls += [P(f, *args, axis=axis, semiring=sr, impl="interpret", **kw)
                  for axis in (0, 1)
                  for f, args, kw in ((j_bsr.bsr_spgemm_reduce, masked[1], {}),
                                      (j_bsr.bsr_pairlist_reduce, red,
                                       {"n_o": 1}))]
    warm_jax(calls)


@pytest.mark.parametrize("sr", RING)
def test_semiring_matmul_nan_matches_pallas(sr):
    a, b = operands(1)
    got = semiring_matmul_ref(a, b, semiring=sr)
    want = j_sm.semiring_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                semiring=sr, impl="interpret")
    assert_equal_nan(got, want)
    g = got.numpy()
    assert np.isnan(g[3]).all() and np.isnan(g[:, 5]).all()
    if sr in ("max_plus", "min_plus"):
        assert np.isnan(g[10, 30]) and np.isnan(g[11, 31])
    if sr == "max_times":
        assert np.isnan(g[12, 32]) and np.isnan(g[13, 33])
    if sr not in ("max_min", "and_or"):   # there ±inf terms meet max(min)
        assert np.isinf(g).any()


@pytest.mark.parametrize("sr", RING)
def test_bsr_spgemm_nan_matches_pallas(sr):
    a, mask, b = t_bsr_ref.masked_ring_nonfinite_operands(
        256, K, N, torch.Generator().manual_seed(2), "cpu")
    got = t_bsr_ref.bsr_spgemm_ref(a, mask, b, semiring=sr)
    j_args = [jnp.asarray(x.numpy()) for x in (a, mask, b)]
    assert_equal_nan(got, j_bsr.bsr_spgemm(*j_args, semiring=sr,
                                           impl="interpret"))
    assert np.isnan(got.numpy()[3]).all()
    # the absent tile's NaN and infinities count nowhere
    assert not np.isnan(got.numpy()[128 + 5]).all()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", RING)
def test_bsr_spgemm_reduce_nan_matches_pallas(sr, axis):
    a, mask, b = t_bsr_ref.masked_ring_nonfinite_operands(
        256, K, N, torch.Generator().manual_seed(3), "cpu")
    got = t_bsr_ref.bsr_spgemm_reduce_ref(a, mask, b, axis=axis, semiring=sr)
    j_args = [jnp.asarray(x.numpy()) for x in (a, mask, b)]
    assert_equal_nan(got, j_bsr.bsr_spgemm_reduce(*j_args, axis=axis,
                                                  semiring=sr,
                                                  impl="interpret"))
    assert np.isnan(got.numpy()).any()


@pytest.mark.parametrize("sr", RING)
def test_bsr_pairlist_nan_matches_pallas(sr):
    a, b = operands(4)
    at, bt, pa, pb, pc, n_c = tiles_of(a, b)
    t_args = [at, bt] + [torch.from_numpy(x) for x in (pa, pb, pc)]
    got = t_bsr_ref.bsr_pairlist_ref(*t_args, n_c=n_c, semiring=sr)
    j_args = [jnp.asarray(x.numpy()) for x in (at, bt)] + [
        jnp.asarray(x) for x in (pa, pb, pc)]
    assert_equal_nan(got, j_bsr.bsr_pairlist(*j_args, n_c=n_c, semiring=sr,
                                             impl="interpret"))
    # one output tile: the pair list of A @ B is the dense product
    assert_equal_nan(got[0], semiring_matmul_ref(a, b, semiring=sr).numpy())


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", RING)
def test_bsr_pairlist_reduce_nan_matches_pallas(sr, axis):
    a, b = operands(5)
    at, bt, pa, pb, pc, _ = tiles_of(a, b)
    po = np.zeros_like(pc)              # the one C tile: one output block
    t_args = [at, bt] + [torch.from_numpy(x) for x in (pa, pb, po)]
    got = t_bsr_ref.bsr_pairlist_reduce_ref(*t_args, n_o=1, axis=axis,
                                            semiring=sr)
    j_args = [jnp.asarray(x.numpy()) for x in (at, bt)] + [
        jnp.asarray(x) for x in (pa, pb, po)]
    assert_equal_nan(got, j_bsr.bsr_pairlist_reduce(
        *j_args, n_o=1, axis=axis, semiring=sr, impl="interpret"))
    assert np.isnan(got.numpy()).any()
