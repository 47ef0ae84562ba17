"""The planned ⊗.⊕ (``spgemm.matmul`` / ``matmul_reduce``) of the port
against the JAX package and the host ``Assoc``: the dense, bsr and coo
strategies, selection fusion through ``a_keep``/``b_keep``, the capacity
overflow contract and the host planner."""
import functools
import warnings

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.spgemm as jsp
import repro_torch.core as T
import repro_torch.core.spgemm as tsp

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (SEMIRINGS, _reset_port_stats,  # noqa: F401
                            assert_same, assert_same_assoc, assert_same_tensor,
                            keys, warm_jax)

IMPLS = ("dense", "bsr", "coo", "auto")


@functools.lru_cache(maxsize=None)
def _operands(seed, n=300, k=330, floats=False, port_only=False):
    """Two arrays over ~3 tiles of keys each (so the bsr path has several
    tiles and pairs), through both packages and the host Assoc (the port's
    alone with ``port_only``); made once per arguments, as no test changes
    them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        r, c = keys(rng, n, k), keys(rng, n, k)
        v = (rng.uniform(0.5, 1.5, n) if floats
             else rng.integers(1, 5, n).astype(float))
        out.append((T.AssocTensor.from_triples(r, c, v, device="cpu"),
                    None if port_only else J.AssocTensor.from_triples(r, c, v),
                    None if port_only else J.Assoc(r, c, v)))
    return out


def _keeps(ta, tb, seed=5):
    """The keep masks of ``test_keep_masks_match``."""
    rng = np.random.default_rng(seed)
    return (rng.random(int(ta.nnz)) < 0.6, rng.random(int(tb.nnz)) < 0.6)


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles):
    """The JAX package's side of the module's parametrised comparisons,
    run first on threads so that its programs compile side by side; each
    test then makes the same calls and compares as before."""
    ops = {s: _operands(s) for s in (1, 3, 4, 6, 9)}
    (_, ja2, _), (_, jb2, _) = _operands(2, floats=True)
    (_, ja1, _), (_, jb1, _) = ops[1]
    (_, ja3, _), (_, jb3, _) = ops[3]
    (ta4, ja4, _), (tb4, jb4, _) = ops[4]
    (ta6, ja6, _), (_, jb6, _) = ops[6]
    (_, ja9, _), _ = ops[9]
    a_keep, b_keep = _keeps(ta4, tb4)
    a6 = np.random.default_rng(7).random(int(ta6.nnz)) < 0.5
    calls = [functools.partial(jsp.matmul, ja1, jb1, sr, impl=impl)
             for sr in SEMIRINGS for impl in IMPLS]
    calls += [functools.partial(jsp.matmul, ja2, jb2, impl=impl)
              for impl in ("dense", "bsr", "coo")]
    calls += [functools.partial(jsp.matmul, ja6, jb6, "min_plus", impl=impl,
                                out_capacity=24)
              for impl in ("dense", "bsr", "coo")]
    calls += [functools.partial(jsp.matmul_reduce, ja3, jb3, axis, sr,
                                impl=impl)
              for sr in SEMIRINGS for impl in IMPLS for axis in (0, 1)]
    calls += [functools.partial(jsp.matmul_reduce, ja6, jb6, axis, sr,
                                impl="dense", kernel_impl="interpret", **kw)
              for sr in SEMIRINGS for axis in (0, 1)
              for kw in ({}, {"a_keep": a6})]
    for sr in ("plus_times", "min_plus", "max_min"):
        for impl in IMPLS:
            kw = {"impl": impl, "a_keep": a_keep, "b_keep": b_keep}
            calls.append(functools.partial(jsp.matmul, ja4, jb4, sr, **kw))
            calls += [functools.partial(jsp.matmul_reduce, ja4, jb4, axis,
                                        sr, **kw) for axis in (0, 1)]
    for sr in ("plus_times", "max_plus"):
        calls += [functools.partial(ja9.sqin, sr),
                  functools.partial(ja9.sqout, sr)]
        calls += [functools.partial(f, sr, reduce=axis)
                  for f in (ja9.sqout, ja9.sqin) for axis in (0, 1)]
    with warnings.catch_warnings():     # the overflow's, which its test
        warnings.simplefilter("ignore", RuntimeWarning)  # records itself
        warm_jax(calls)


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


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_dense_matmul_reduce_matches_pallas_interpret(sr, axis):
    """The dense strategy's fused reduce (the plain version of the
    ``bsr_spgemm_reduce`` kernel on the CPU) against the JAX package's
    Pallas kernel in interpret mode, plain and with keep masks (the
    filtered path builds its own block mask); integer values, exact."""
    (ta, ja, _), (tb, jb, _) = _operands(6)
    got = tsp.matmul_reduce(ta, tb, axis, sr, impl="dense")
    assert_same(got, jsp.matmul_reduce(ja, jb, axis, sr, impl="dense",
                                       kernel_impl="interpret"),
                sr, floats=False)
    rng = np.random.default_rng(7)
    a_keep = rng.random(int(ta.nnz)) < 0.5
    got = tsp.matmul_reduce(ta, tb, axis, sr, impl="dense", a_keep=a_keep)
    assert_same(got, jsp.matmul_reduce(ja, jb, axis, sr, impl="dense",
                                       kernel_impl="interpret",
                                       a_keep=a_keep), sr, floats=False)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "max_min"])
def test_keep_masks_match(sr, impl):
    """Selection fusion: host keep masks slice the operands' entry lists."""
    (ta, ja, _), (tb, jb, _) = _operands(4)
    a_keep, b_keep = _keeps(ta, tb)
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
    (ta, _, _), (tb, _, _) = _operands(7, port_only=True)
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
    (ta, _, _), (tb, _, _) = _operands(10, n=20, k=20, port_only=True)
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
    (ta, _, _), (tb, _, _) = _operands(11, port_only=True)
    want = tsp.matmul(ta, tb, impl=impl)
    with tsp.stage_timing() as ms:
        got = tsp.matmul(ta, tb, impl=impl)
    assert set(ms) == stages and all(t >= 0 for t in ms.values())
    assert_same_assoc(got.to_assoc(), want.to_assoc())
    timed = dict(ms)
    tsp.matmul(ta, tb, impl=impl)
    assert tsp.STAGE_MS == timed             # no span added outside


def test_stage_timing_dense_matmul_reduce():
    (ta, _, _), (tb, _, _) = _operands(12, port_only=True)
    want = tsp.matmul_reduce(ta, tb, 0, impl="dense")
    with tsp.stage_timing() as ms:
        got = tsp.matmul_reduce(ta, tb, 0, impl="dense")
    assert set(ms) == {"align", "valid_host", "densify", "kernel"}
    assert torch.equal(got, want)


def test_stage_timing_matmul_reduce():
    (ta, _, _), (tb, _, _) = _operands(12, port_only=True)
    want = tsp.matmul_reduce(ta, tb, 1, impl="bsr")
    with tsp.stage_timing() as ms:
        got = tsp.matmul_reduce(ta, tb, 1, impl="bsr")
    assert set(ms) == {"align", "valid_host", "plan", "pack_tiles",
                       "reduce_pairs", "kernel", "fold"}
    assert torch.equal(got, want)
