"""The port's foundations against the JAX package on the same inputs:
semirings, sorted-set ops, COO canonicalization, keyspaces, selectors, the
host Assoc, AssocTensor and the state conversion, plus the port's
isolation from JAX."""
import pathlib
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.coo as jcoo
import repro.core.sorted_ops as jso
import repro_torch.core as T
import repro_torch.core.coo as tcoo
import repro_torch.core.sorted_ops as tso
from repro_torch.convert import from_jax_state, to_numpy_state

from _torch_helpers import (SEMIRINGS, _reset_port_stats,  # noqa: F401
                            assert_same, assert_same_assoc, assert_same_tensor,
                            keys, np_of)

SENT = 2 ** 31 - 1
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


# -- semirings -----------------------------------------------------------------

def test_registry_matches():
    assert set(T.REGISTRY) == set(J.REGISTRY) == set(SEMIRINGS)
    for name in SEMIRINGS:
        t, j = T.REGISTRY[name], J.REGISTRY[name]
        assert (t.zero, t.one, t.mxu, t.idempotent_add, t.add_kind) == \
            (j.zero, j.one, j.mxu, j.idempotent_add, j.add_kind)
        assert t.add_np is j.add_np and t.mul_np is j.mul_np
    assert T.STRING.add_py("ab", "c") == J.STRING.add_py("ab", "c")
    assert T.get_semiring("min_plus") is T.MIN_PLUS
    with pytest.raises(KeyError):
        T.get_semiring("nope")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_semiring_ops_match(name):
    rng = np.random.default_rng(1)
    a = rng.integers(-3, 4, (6, 5)).astype(np.float32)
    b = rng.integers(-3, 4, (5, 7)).astype(np.float32)
    t, j = T.REGISTRY[name], J.REGISTRY[name]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_same(t.add(ta, ta.flip(0)), j.add(a, a[::-1]), name, False)
    assert_same(t.mul(ta, ta.flip(0)), j.mul(a, a[::-1]), name, False)
    for axis in (0, 1, None):
        assert_same(t.add_reduce(ta, axis=axis), j.add_reduce(a, axis=axis),
                    name, False)
    assert_same(t.matmul_dense(ta, tb), j.matmul_dense(a, b), name, False)
    z = np.array([t.zero, 1.0, t.zero], np.float32)
    assert_same(t.is_zero(torch.from_numpy(z)), j.is_zero(z), name, False)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_scatter_combine_matches(name):
    rng = np.random.default_rng(2)
    t, j = T.REGISTRY[name], J.REGISTRY[name]
    idx = rng.integers(-2, 9, 40).astype(np.int32)   # some out of range
    idx[:3] = SENT
    vals = rng.normal(size=40).astype(np.float32)
    vec = np.full(7, t.zero, np.float32)
    got = T.scatter_combine(torch.from_numpy(vec), torch.from_numpy(idx),
                            torch.from_numpy(vals), t)
    want = J.scatter_combine(jnp.asarray(vec), jnp.asarray(idx),
                             jnp.asarray(vals), j)
    assert_same(got, want, name)
    # rows of a 2-D buffer, indexed by a 2-D index (the fused-reduce epilogue)
    vec2 = np.full((5, 3), t.zero, np.float32)
    idx2 = rng.integers(0, 6, (2, 4)).astype(np.int32)
    vals2 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    got = T.scatter_combine(torch.from_numpy(vec2), torch.from_numpy(idx2),
                            torch.from_numpy(vals2), t)
    want = J.scatter_combine(jnp.asarray(vec2), jnp.asarray(idx2),
                             jnp.asarray(vals2), j)
    assert_same(got, want, name)


# -- sorted-set ops --------------------------------------------------------------

def _padded(rng, n, cap, k):
    x = np.unique(rng.integers(0, k, n)).astype(np.int32)[:cap]
    return np.concatenate([x, np.full(cap - len(x), SENT, np.int32)])


@pytest.mark.parametrize("seed", range(4))
def test_sorted_ops_match(seed):
    rng = np.random.default_rng(seed)
    i = np.unique(rng.integers(0, 30, 12))
    j = np.unique(rng.integers(0, 30, 9))
    for fn in ("sorted_union", "sorted_intersect"):
        for x, y in zip(getattr(tso, fn)(i, j), getattr(jso, fn)(i, j)):
            np.testing.assert_array_equal(x, y)
    pi, pj = _padded(rng, 10, 12, 25), _padded(rng, 8, 10, 25)
    for fn in ("sorted_union_padded", "sorted_intersect_padded"):
        got = getattr(tso, fn)(torch.from_numpy(pi), torch.from_numpy(pj))
        want = getattr(jso, fn)(jnp.asarray(pi), jnp.asarray(pj))
        k_t, nk_t = np_of(got[0]), int(got[1])
        k_j, nk_j = np.asarray(want[0]), int(want[1])
        assert nk_t == nk_j
        np.testing.assert_array_equal(k_t, k_j)
        # index maps agree on the valid inputs
        for m_t, m_j, src in ((got[2], want[2], pi), (got[3], want[3], pj)):
            if fn == "sorted_union_padded":
                ok = src != SENT
                np.testing.assert_array_equal(np_of(m_t)[ok],
                                              np.asarray(m_j)[ok])
            else:
                np.testing.assert_array_equal(np_of(m_t)[:nk_t],
                                              np.asarray(m_j)[:nk_j])


# -- COO core --------------------------------------------------------------------

def _triples(rng, n=48, k=6, pad=6):
    r = rng.integers(0, k, n).astype(np.int32)
    c = rng.integers(0, k, n).astype(np.int32)
    v = rng.integers(-2, 5, n).astype(np.float32)
    r[-pad:] = SENT
    c[-pad:] = SENT
    return r, c, v


@pytest.mark.parametrize("combine", ["add", "minimum", "maximum", "custom"])
def test_dedup_sorted_coo_union_matches(combine):
    rng = np.random.default_rng(3)
    r, c, v = _triples(rng)
    if combine == "custom":   # an arbitrary ⊕ takes the doubling-scan path
        tfn, jfn = (lambda a, b: torch.maximum(a, b),
                    lambda a, b: jnp.maximum(a, b))
    else:
        tfn, jfn = getattr(torch, combine), getattr(jnp, combine)
    got = tcoo.dedup_sorted_coo(torch.from_numpy(r), torch.from_numpy(c),
                                torch.from_numpy(v), tfn, zero=0.0)
    want = jcoo.dedup_sorted_coo(jnp.asarray(r), jnp.asarray(c),
                                 jnp.asarray(v), jfn, zero=0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_dedup_sorted_coo_pairs_match(name):
    """Element-wise ⊗ (run-length-2 intersection) with the source flags."""
    rng = np.random.default_rng(4)
    sr_t, sr_j = T.REGISTRY[name], J.REGISTRY[name]
    a = np.unique(rng.integers(0, 30, 14))
    b = np.unique(rng.integers(0, 30, 14))
    r = np.concatenate([a // 6, b // 6, [SENT, SENT]]).astype(np.int32)
    c = np.concatenate([a % 6, b % 6, [SENT, SENT]]).astype(np.int32)
    v = rng.integers(1, 5, len(r)).astype(np.float32)
    src = np.concatenate([np.zeros(len(a) + 1), np.ones(len(b) + 1)]
                         ).astype(np.int32)
    got = tcoo.dedup_sorted_coo(
        torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(v),
        sr_t.add, zero=sr_t.zero, require_pair=True, pair_op=sr_t.mul,
        src=torch.from_numpy(src))
    want = jcoo.dedup_sorted_coo(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), sr_j.add,
        zero=sr_j.zero, require_pair=True, pair_op=sr_j.mul,
        src=jnp.asarray(src))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_expand_join_coo_matches(name):
    rng = np.random.default_rng(5)
    sr_t, sr_j = T.REGISTRY[name], J.REGISTRY[name]
    ar, ac, av = (np.asarray(x) for x in jcoo.dedup_sorted_coo(
        *map(jnp.asarray, _triples(rng, 30, 5, 4)), jnp.add)[:3])
    br, bc, bv = (np.asarray(x) for x in jcoo.dedup_sorted_coo(
        *map(jnp.asarray, _triples(rng, 30, 5, 4)), jnp.add)[:3])
    got = tcoo.expand_join_coo(*map(torch.from_numpy, (ar, ac, av, br, bc, bv)),
                               sr_t.mul, zero=sr_t.zero, expand=96)
    want = jcoo.expand_join_coo(*map(jnp.asarray, (ar, ac, av, br, bc, bv)),
                                sr_j.mul, zero=sr_j.zero, expand=96)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


def test_host_coo_helpers_match():
    rng = np.random.default_rng(6)
    r, c = rng.integers(0, 5, 40), rng.integers(0, 5, 40)
    v = rng.integers(1, 9, 40).astype(float)
    for x, y in zip(tcoo.canonicalize_np(r, c, v, "sum"),
                    jcoo.canonicalize_np(r, c, v, "sum")):
        np.testing.assert_array_equal(x, y)
    s = np.array(["b", "a", "c"] * 4)
    for x, y in zip(tcoo.canonicalize_np(r[:12], c[:12], s, "concat"),
                    jcoo.canonicalize_np(r[:12], c[:12], s, "concat")):
        np.testing.assert_array_equal(x, y)
    la = tcoo.linearize_pairs_np(r, c, 5)
    np.testing.assert_array_equal(la, jcoo.linearize_pairs_np(r, c, 5))
    order = np.argsort(r, kind="stable")
    args = (r, c, v, r[order], c[order], v[order])
    for x, y in zip(tcoo.spgemm_np(*args, np.multiply, np.add),
                    jcoo.spgemm_np(*args, np.multiply, np.add)):
        np.testing.assert_array_equal(x, y)


# -- keyspace / selectors ----------------------------------------------------------

def test_keyspace_matches():
    rng = np.random.default_rng(7)
    a, b = keys(rng, 30, 40), keys(rng, 30, 40)
    ta, tb = T.KeySpace(a), T.KeySpace(b)
    ja, jb = J.KeySpace(a), J.KeySpace(b)
    assert ta.digest == ja.digest
    np.testing.assert_array_equal(ta.rank(a)[0], ja.rank(a)[0])
    assert ta.rank_range("0005", "0020") == ja.rank_range("0005", "0020")
    for x, y in zip(ta.union(tb), ja.union(jb)):
        np.testing.assert_array_equal(getattr(x, "keys", x),
                                      getattr(y, "keys", y))


def _selectors(mod):
    return [mod.Range("0005", "0020"), mod.Keys(["0003", "0011", "0030"]),
            mod.StartsWith("001"), mod.Match(r"00[12]"),
            mod.Range("0005", "0030") & ~mod.StartsWith("001"),
            mod.Keys(["0001"]) | mod.Range("0010", "0012"), mod.All()]


def test_compile_selector_and_plan_boxes_match():
    rng = np.random.default_rng(8)
    ks = keys(rng, 60, 40)
    ts, js = T.KeySpace(ks), J.KeySpace(ks)
    tcs = [T.compile_selector(s, ts) for s in _selectors(T)]
    jcs = [J.compile_selector(s, js) for s in _selectors(J)]
    for tc, jc in zip(tcs, jcs):
        assert (tc.lo, tc.hi, tc.n, tc.is_range, tc.count) == \
            (jc.lo, jc.hi, jc.n, jc.is_range, jc.count)
        np.testing.assert_array_equal(tc.mask(), jc.mask())
    from repro.core.select import plan_boxes as jplan
    from repro_torch.core.select import plan_boxes as tplan
    for a in range(len(tcs)):
        for b in range(len(tcs)):
            got = tplan(tcs[a], tcs[b], len(ks), len(ks))
            want = jplan(jcs[a], jcs[b], len(ks), len(ks))
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


# -- host Assoc --------------------------------------------------------------------

@pytest.mark.parametrize("name", SEMIRINGS)
def test_host_assoc_matches(name):
    rng = np.random.default_rng(9)
    r, c = keys(rng, 60, 20), keys(rng, 60, 20)
    r2, c2 = keys(rng, 60, 20), keys(rng, 60, 20)
    v = rng.integers(1, 6, 60).astype(float)
    ta, tb = T.Assoc(r, c, v), T.Assoc(r2, c2, v)
    ja, jb = J.Assoc(r, c, v), J.Assoc(r2, c2, v)
    for op in ("add", "mul", "matmul"):
        assert_same_assoc(getattr(ta, op)(tb, name), getattr(ja, op)(jb, name))
    np.testing.assert_array_equal(ta.matmul_reduce(tb, 1, name),
                                  ja.matmul_reduce(jb, 1, name))
    sel = ("0003,:,0012,", slice(None))
    assert_same_assoc(ta[sel], ja[sel])


# -- AssocTensor --------------------------------------------------------------------

def _pair(rng, n=80, k=25, values=None):
    r, c = keys(rng, n, k), keys(rng, n, k)
    v = rng.integers(1, 6, n).astype(float) if values is None else values
    return ((T.AssocTensor.from_triples(r, c, v, device="cpu"),
             J.AssocTensor.from_triples(r, c, v)), (r, c, v))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_assoc_tensor_algebra_matches(name):
    rng = np.random.default_rng(10)
    (ta, ja), _ = _pair(rng)
    (tb, jb), _ = _pair(rng)
    assert_same_tensor(ta, ja)
    assert_same_tensor(ta.add(tb, name), ja.add(jb, name), name, False)
    assert_same_tensor(ta.mul(tb, name), ja.mul(jb, name), name, False)
    assert_same_tensor(ta.transpose(), ja.transpose())
    assert_same_tensor(ta.logical(), ja.logical())
    assert_same(ta.reduce_rows(name), ja.reduce_rows(name), name, False)
    assert_same(ta.reduce_cols(name), ja.reduce_cols(name), name, False)
    assert_same_assoc(ta.to_assoc(), ja.to_assoc())


def test_assoc_tensor_aggregate_and_string_values():
    rng = np.random.default_rng(11)
    r, c = keys(rng, 50, 6), keys(rng, 50, 6)
    v = rng.integers(1, 6, 50).astype(float)
    for agg in ("min", "max", "sum"):
        assert_same_tensor(
            T.AssocTensor.from_triples(r, c, v, aggregate=agg, device="cpu"),
            J.AssocTensor.from_triples(r, c, v, aggregate=agg),
            "plus_times" if agg == "sum" else "max_plus", False)
    s = np.array(["x", "yy", "a", "zz", "b"])[rng.integers(0, 5, 50)]
    t = T.AssocTensor.from_triples(r, c, s, device="cpu")
    j = J.AssocTensor.from_triples(r, c, s)
    assert_same_tensor(t, j)
    np.testing.assert_array_equal(t.val_space.keys, j.val_space.keys)
    assert_same_assoc(t.to_assoc(), j.to_assoc())


def test_dense_adj_round_trip_and_overflow():
    rng = np.random.default_rng(12)
    (ta, ja), _ = _pair(rng, 60, 20)
    da, dj = ta.to_dense_adj(zero=-np.inf), ja.to_dense_adj(zero=-np.inf)
    np.testing.assert_array_equal(np_of(da), np.asarray(dj))
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        t = T.AssocTensor.from_dense_adj(da, ta.row_space, ta.col_space, 16,
                                         zero=-np.inf)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        j = J.AssocTensor.from_dense_adj(dj, ja.row_space, ja.col_space, 16,
                                         zero=-np.inf)
    assert t.overflow and bool(j.overflow)
    assert [w.category for w in wt] == [w.category for w in wj] == \
        [RuntimeWarning]
    assert_same_tensor(t, j)


@pytest.mark.parametrize("sel,path", [
    (("0003,:,0015,", slice(None)), "range"),
    ((T.Keys(["0001", "0002", "0009", "0010"]), slice(None)), "multirange"),
    ((T.Range("0002", "0020"), T.Match(r"00[01][13579]")), "hybrid"),
    ((T.Match(r"00[01][13579]"), T.Match(r"00[12][02468]")), "gather"),
])
def test_selection_dispatch_matches(sel, path):
    rng = np.random.default_rng(13)
    (ta, ja), _ = _pair(rng, 120, 25)

    def jsel(s):
        return J.as_selector(s) if isinstance(s, T.Selector) and not \
            isinstance(s, (T.Keys, T.Range, T.Match)) else _to_j(s)
    jij = tuple(jsel(s) for s in sel)
    assert_same_tensor(ta[sel], ja[jij])
    assert T.DISPATCH_STATS == J.DISPATCH_STATS
    assert T.DISPATCH_STATS[path] == 1
    ta[sel] = 7.5
    ja[jij] = 7.5
    assert_same_tensor(ta, ja)


def _to_j(s):
    """The JAX twin of a port selector built above (or a plain key form)."""
    if isinstance(s, T.Keys):
        return J.Keys(list(s.keys))
    if isinstance(s, T.Range):
        return J.Range(s.lo, s.hi)
    if isinstance(s, T.Match):
        return J.Match(s.pattern)
    return s


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        T.AssocTensor.from_triples(["a"], ["b"], [1.0])


def test_convert_round_trip():
    rng = np.random.default_rng(14)
    (_, ja), _ = _pair(rng)
    state = dict(rows=np.asarray(ja.rows), cols=np.asarray(ja.cols),
                 vals=np.asarray(ja.vals), nnz=np.asarray(ja.nnz),
                 row_keys=ja.row_space.keys, col_keys=ja.col_space.keys)
    t = from_jax_state(**state, device="cpu")
    assert_same_tensor(t, ja)
    back = to_numpy_state(t)
    for k in ("rows", "cols", "vals", "row_keys", "col_keys"):
        np.testing.assert_array_equal(back[k], state[k])
    assert back["nnz"] == int(ja.nnz) and back["val_keys"] is None
    assert_same_assoc(t.to_assoc(), ja.to_assoc())


# -- isolation from JAX and from repro -----------------------------------------------

def test_port_imports_without_jax():
    prog = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.main_path, repro_torch.kernels.range_extract, "
            "repro_torch.kernels.semiring_matmul, "
            "repro_torch.kernels.bsr_spgemm; "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m == 'repro' or m.startswith(('repro.', 'jax')))]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_port_sources_never_import_repro():
    files = list((SRC / "repro_torch").rglob("*.py"))
    assert files
    for f in files:
        text = f.read_text()
        assert "import repro." not in text and "from repro." not in text, f
        assert "import jax" not in text and "from jax" not in text, f
