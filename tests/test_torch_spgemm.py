"""The planned ⊗.⊕ (``spgemm.matmul`` / ``matmul_reduce``) of the port
against the JAX package and the host ``Assoc``: the dense, bsr and coo
strategies, selection fusion through ``a_keep``/``b_keep``, the capacity
overflow contract and the host planner."""
import warnings

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.spgemm as jsp
import repro_torch.core as T
import repro_torch.core.spgemm as tsp

from _torch_helpers import (SEMIRINGS, _reset_port_stats,  # noqa: F401
                            assert_same, assert_same_assoc, assert_same_tensor,
                            keys)

IMPLS = ("dense", "bsr", "coo", "auto")


def _operands(seed, n=300, k=330, floats=False):
    """Two arrays over ~3 tiles of keys each (so the bsr path has several
    tiles and pairs), through both packages and the host Assoc."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        r, c = keys(rng, n, k), keys(rng, n, k)
        v = (rng.uniform(0.5, 1.5, n) if floats
             else rng.integers(1, 5, n).astype(float))
        out.append((T.AssocTensor.from_triples(r, c, v, device="cpu"),
                    J.AssocTensor.from_triples(r, c, v), J.Assoc(r, c, v)))
    return out


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_matmul_matches(sr, impl):
    (ta, ja, ha), (tb, jb, hb) = _operands(1)
    got = tsp.matmul(ta, tb, sr, impl=impl)
    want = jsp.matmul(ja, jb, sr, impl=impl)
    assert_same_tensor(got, want, sr, floats=False)
    assert got.overflow == bool(want.overflow) is False
    assert_same_assoc(got.to_assoc(), ha.matmul(hb, sr))


def test_matmul_plus_times_random_floats():
    (ta, ja, _), (tb, jb, _) = _operands(2, floats=True)
    for impl in ("dense", "bsr", "coo"):
        assert_same_tensor(tsp.matmul(ta, tb, impl=impl),
                           jsp.matmul(ja, jb, impl=impl), "plus_times")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_matmul_reduce_matches(sr, impl, axis):
    (ta, ja, ha), (tb, jb, hb) = _operands(3)
    got = tsp.matmul_reduce(ta, tb, axis, sr, impl=impl)
    assert_same(got, jsp.matmul_reduce(ja, jb, axis, sr, impl=impl), sr,
                floats=False)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "max_min"])
def test_keep_masks_match(sr, impl):
    """Selection fusion: host keep masks slice the operands' entry lists."""
    (ta, ja, _), (tb, jb, _) = _operands(4)
    rng = np.random.default_rng(5)
    a_keep = rng.random(int(ta.nnz)) < 0.6
    b_keep = rng.random(int(tb.nnz)) < 0.6
    assert_same_tensor(
        tsp.matmul(ta, tb, sr, impl=impl, a_keep=a_keep, b_keep=b_keep),
        jsp.matmul(ja, jb, sr, impl=impl, a_keep=a_keep, b_keep=b_keep),
        sr, floats=False)
    for axis in (0, 1):
        assert_same(
            tsp.matmul_reduce(ta, tb, axis, sr, impl=impl, a_keep=a_keep,
                              b_keep=b_keep),
            jsp.matmul_reduce(ja, jb, axis, sr, impl=impl, a_keep=a_keep,
                              b_keep=b_keep), sr, floats=False)
    with pytest.raises(ValueError, match="keep mask"):
        tsp.matmul(ta, tb, sr, impl=impl, a_keep=a_keep[:-1])


@pytest.mark.parametrize("impl", ["dense", "bsr", "coo"])
def test_overflow_matches(impl):
    """A too-small out_capacity truncates to the same leading entries, sets
    ``overflow`` and warns, on both packages."""
    (ta, ja, _), (tb, jb, _) = _operands(6)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tsp.matmul(ta, tb, "min_plus", impl=impl, out_capacity=24)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jsp.matmul(ja, jb, "min_plus", impl=impl, out_capacity=24)
    assert got.overflow and bool(want.overflow)
    assert any(w.category is RuntimeWarning for w in wt)
    assert [w.category for w in wt] == [w.category for w in wj]
    assert_same_tensor(got, want, "min_plus", floats=False)


def test_plan_and_estimate_match():
    (ta, _, _), (tb, _, _) = _operands(7)
    ta, tb, ks = tsp._contraction_aligned(ta, tb, T.PLUS_TIMES)
    ra, ca, _ = tsp._valid_host(ta)
    rb, cb, _ = tsp._valid_host(tb)
    args = (ra, ca, rb, cb, len(ta.row_space), len(ks), len(tb.col_space))
    for impl in ("auto", "bsr", "dense"):
        tp, jp = tsp.plan_matmul(*args, impl=impl), jsp.plan_matmul(*args,
                                                                    impl=impl)
        for f in ("impl", "m", "k", "n", "products", "dense_cost", "bsr_cost"):
            assert getattr(tp, f) == getattr(jp, f), f
        for f in ("a_tile_of", "a_blocks", "b_tile_of", "b_blocks", "pair_a",
                  "pair_b", "pair_c", "c_blocks"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        assert tsp.estimate_out_nnz(tp) == jsp.estimate_out_nnz(jp)
    pa, pb, po, ou = tsp.reduce_pairs(tp, 1)
    assert (np.diff(po) >= 0).all() and len(ou) == po.max() + 1


def test_tiles_to_coo_is_canonical():
    """The sort-free tile extraction against a numpy lexsort of all cells,
    with ragged block-rows and cells beyond (m, n)."""
    rng = np.random.default_rng(8)
    c_blocks = np.array([[0, 0], [0, 2], [1, 1], [3, 0], [3, 1], [3, 2]],
                        np.int32)
    tiles = rng.integers(0, 3, (len(c_blocks), 128, 128)).astype(np.float32)
    m, n = 3 * 128 + 40, 2 * 128 + 17
    for cap in (10 ** 6, 1000):
        r, c, v, true_nnz = tsp.tiles_to_coo(torch.from_numpy(tiles),
                                             c_blocks, m, n, 0.0, cap)
        bi = c_blocks[:, 0, None, None] * 128 + np.arange(128)[None, :, None]
        bj = c_blocks[:, 1, None, None] * 128 + np.arange(128)[None, None, :]
        rows = np.broadcast_to(bi, tiles.shape).ravel()
        cols = np.broadcast_to(bj, tiles.shape).ravel()
        ok = (tiles.ravel() != 0) & (rows < m) & (cols < n)
        order = np.lexsort((cols[ok], rows[ok]))
        assert true_nnz == ok.sum()
        np.testing.assert_array_equal(r.numpy(), rows[ok][order][:cap])
        np.testing.assert_array_equal(c.numpy(), cols[ok][order][:cap])
        np.testing.assert_array_equal(v.numpy(), tiles.ravel()[ok][order][:cap])


@pytest.mark.parametrize("sr", ["plus_times", "max_plus"])
def test_sq_idioms_match(sr):
    (ta, ja, ha), _ = _operands(9)
    assert_same_tensor(ta.sqin(sr), ja.sqin(sr), sr, floats=False)
    assert_same_tensor(ta.sqout(sr), ja.sqout(sr), sr, floats=False)
    for axis in (0, 1):
        assert_same(ta.sqout(sr, reduce=axis), ja.sqout(sr, reduce=axis), sr,
                    floats=False)
        assert_same(ta.sqin(sr, reduce=axis), ja.sqin(sr, reduce=axis), sr,
                    floats=False)
    np.testing.assert_array_equal(ta.sqout(reduce=1).numpy(),
                                  ha.sqout(reduce=1))


def test_bad_impl_raises():
    (ta, _, _), (tb, _, _) = _operands(10, n=20, k=20)
    with pytest.raises(ValueError, match="impl"):
        tsp.matmul(ta, tb, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tsp.matmul_reduce(ta, tb, 1, impl="pallas")


@pytest.mark.parametrize("impl, stages", [
    ("bsr", {"align", "valid_host", "plan", "estimate_out_nnz", "pack_tiles",
             "kernel", "tiles_to_coo"}),
    ("dense", {"align", "valid_host", "densify", "kernel", "from_dense_adj"}),
])
def test_stage_timing_records_each_stage(impl, stages):
    """Stage spans change no result, cover every stage the strategy runs,
    and are off outside ``stage_timing``."""
    (ta, _, _), (tb, _, _) = _operands(11)
    want = tsp.matmul(ta, tb, impl=impl)
    with tsp.stage_timing() as ms:
        got = tsp.matmul(ta, tb, impl=impl)
    assert set(ms) == stages and all(t >= 0 for t in ms.values())
    assert_same_assoc(got.to_assoc(), want.to_assoc())
    timed = dict(ms)
    tsp.matmul(ta, tb, impl=impl)
    assert tsp.STAGE_MS == timed             # no span added outside


def test_stage_timing_matmul_reduce():
    (ta, _, _), (tb, _, _) = _operands(12)
    want = tsp.matmul_reduce(ta, tb, 1, impl="bsr")
    with tsp.stage_timing() as ms:
        got = tsp.matmul_reduce(ta, tb, 1, impl="bsr")
    assert set(ms) == {"align", "valid_host", "plan", "pack_tiles",
                       "reduce_pairs", "kernel", "fold"}
    assert torch.equal(got, want)
