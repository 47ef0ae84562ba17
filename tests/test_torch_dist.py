"""The port's sharded ``DistAssoc`` (``repro_torch.core.dist_assoc``) against
the JAX package's (``repro.core.dist_assoc``).

* One rank, in this process, on the gloo mesh of ``cpu_mesh()``, against
  the JAX 1-shard ``DistAssoc`` on the same numpy inputs — shard arrays
  and results alike: the three-layer selector parity over every selector
  form (the fixtures of ``tests/test_select.py``), the lazy transpose and
  element-wise pipelines, row reduction and scalar assignment
  (``tests/test_expr.py``), ``add``/``mul``/``col_reduce``/``row_reduce``/
  ``matmul_dense_vec`` under every semiring, ``col_degree``, the
  conversions, and the dist main path at a small size.
* Four ranks: one JAX process on four host devices and four port ranks on
  one gloo group (importing neither ``jax`` nor ``repro``) run the same ops
  on the same triples; every rank's shard equals the JAX shard of that
  index, and ``to_assoc``/``gather_replicated``/lazy ``.T`` (which the
  JAX package cannot run at four shards) equal the host ``Assoc``.
* The collectives each entry point makes equal the JAX ``@contract``.

Tolerances: ranks, ``nnz``, bounds and values from integer inputs are
exact; the float-valued fixtures of ``tests/test_select.py`` and
``tests/test_expr.py`` compare at ``rtol=1e-5``, their reductions at
``rtol=1e-4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.select as JS
import repro_torch.core as T
import repro_torch.core.select as TS
from repro.analysis.contracts import CONTRACT_ATTR
from repro.core.dist_assoc import DistAssoc as JDist
from repro_torch import convert, main_path
from repro_torch.core import COLLECTIVE_STATS, DistAssoc
from repro_torch.core.collectives import collective_count
from repro_torch.core.mesh import Mesh

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            SpmdRun, cpu_mesh)

RTOL = 1e-5
RTOL_REDUCE = 1e-4


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module", autouse=True)
def _free_jax_programs():
    """Free the XLA programs this module compiled when it ends: each keeps
    memory maps, and one pytest process runs the whole suite under the
    kernel's limit on them."""
    yield
    jax.clear_caches()


def _both(rows, cols, vals, jmesh, **kw):
    """The port's one-rank DistAssoc and the JAX 1-shard one."""
    return (DistAssoc.from_triples(rows, cols, vals, cpu_mesh(),
                                   device="cpu", **kw),
            JDist.from_triples(rows, cols, vals, jmesh, **kw))


def assert_same_dist(t, j, rtol=0.0):
    """A one-rank port DistAssoc against a JAX 1-shard DistAssoc: the shard
    arrays, the bounds and the keyspaces."""
    loc, jl = t.local, j.local
    assert int(loc.nnz) == int(np.asarray(jl.nnz)[0])
    np.testing.assert_array_equal(loc.rows.numpy(), np.asarray(jl.rows)[0])
    np.testing.assert_array_equal(loc.cols.numpy(), np.asarray(jl.cols)[0])
    np.testing.assert_allclose(loc.vals.numpy(), np.asarray(jl.vals)[0],
                               rtol=rtol)
    np.testing.assert_array_equal(t.row_bounds, j.row_bounds)
    np.testing.assert_array_equal(loc.row_space.keys, jl.row_space.keys)
    np.testing.assert_array_equal(loc.col_space.keys, jl.col_space.keys)


def _dict_close(got: dict, want: dict, rtol=RTOL):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol), k


# ---------------------------------------------------------------------------
# three-layer selector parity (the fixtures of tests/test_select.py)
# ---------------------------------------------------------------------------

FRUITS = ["apple", "apricot", "banana", "cherry", "date", "fig", "grape",
          "kiwi", "lemon", "mango"]
MASK_BITS = np.zeros(len(FRUITS), bool)
MASK_BITS[[0, 4, 7]] = True


def _selectors(S):
    return [
        ("explicit-keys", (S.Keys(["banana", "kiwi", "nope"]), ":")),
        ("string-list", ("banana,kiwi,", ":")),
        ("range-string", ("banana,:,fig,", ":")),
        ("range-obj", (S.Range("banana", "fig"), ":")),
        ("startswith", (S.StartsWith("ap,"), ":")),
        ("match", (S.Match("an"), ":")),
        ("where", (S.Where(lambda k: len(k) == 4), ":")),
        ("mask", (S.Mask(MASK_BITS), ":")),
        ("all", (":", ":")),
        ("composed-or", (S.StartsWith("ap,") | S.Keys(["mango"]), ":")),
        ("composed-and-not", (S.StartsWith("a,b,") & ~S.Keys(["banana"]),
                              ":")),
        ("empty", (S.Keys(["nothing-matches"]), ":")),
        ("col-and-both-axes", (S.StartsWith("ap,"), "c0,c3,")),
        ("empty-range-string", ("zzz,:,zzzz,", ":")),
    ]


SELECTOR_NAMES = [n for n, _ in _selectors(TS)]


@pytest.fixture(scope="module")
def layers(jmesh):
    rng = np.random.default_rng(7)
    rows = np.asarray(FRUITS * 3)
    cols = np.asarray([f"c{i % 5}" for i in range(len(rows))])
    vals = np.round(rng.uniform(0.5, 9.5, len(rows)), 2)
    t, j = _both(rows, cols, vals, jmesh, aggregate="sum")
    return t, j, T.Assoc(rows, cols, vals, aggregate="sum")


def _dispatch(arr, stats, ij):
    for k in stats:
        stats[k] = 0
    out = arr[ij[0], ij[1]]
    return out, {k for k, v in stats.items() if v}


@pytest.mark.parametrize("name", SELECTOR_NAMES)
def test_three_layer_parity(layers, name):
    t, j, host = layers
    tsel = dict(_selectors(TS))[name]
    got, t_kind = _dispatch(t, T.DISPATCH_STATS, tsel)
    want, j_kind = _dispatch(j, J.DISPATCH_STATS, dict(_selectors(JS))[name])
    assert t_kind == j_kind
    assert_same_dist(got, want, rtol=RTOL)
    _dict_close(got.to_assoc().to_dict(), host[tsel].to_dict())


WIDE_ROWS = [f"r{i:02d}" for i in range(20)]
WIDE_COLS = [f"d{i:02d}" for i in range(20)]


def _wide_selectors(S):
    spill = [k for i, k in enumerate(WIDE_ROWS) if i % 4 in (0, 1)]
    spill_cols = [k for i, k in enumerate(WIDE_COLS) if i % 4 in (0, 1)]
    return [
        ("scatter-both", (S.Keys(WIDE_ROWS[::2]), S.Keys(WIDE_COLS[::2])),
         "gather"),
        ("scatter-rows", (S.Keys(WIDE_ROWS[::2]), S.All()), "hybrid"),
        ("spill-rows", (S.Keys(spill), S.All()), "hybrid"),
        ("spill-both", (S.Keys(spill), S.Keys(spill_cols)), "gather"),
        ("box-product-spill",
         (S.Keys(WIDE_ROWS[0:3] + WIDE_ROWS[8:11]),
          S.Keys([WIDE_COLS[0], WIDE_COLS[5], WIDE_COLS[10]])), "multirange"),
        ("few-runs", (S.Keys(WIDE_ROWS[0:2] + WIDE_ROWS[10:12]),
                      S.Keys([WIDE_COLS[0], WIDE_COLS[9]])), "multirange"),
    ]


@pytest.fixture(scope="module")
def wide_layers(jmesh):
    rng = np.random.default_rng(11)
    rows = np.asarray(WIDE_ROWS * 4)
    cols = np.asarray([WIDE_COLS[(3 * i) % 20] for i in range(len(rows))])
    vals = np.round(rng.uniform(0.5, 9.5, len(rows)), 2)
    t, j = _both(rows, cols, vals, jmesh, aggregate="sum")
    return t, j, T.Assoc(rows, cols, vals, aggregate="sum")


@pytest.mark.parametrize("name", [n for n, _, _ in _wide_selectors(TS)])
def test_wide_selector_dispatch_parity(wide_layers, name):
    """The membership-gather fallback and the plan_boxes spills: the same
    dispatch path and the same shard as JAX, the host's entries."""
    t, j, host = wide_layers
    tsel, kind = {n: (s, k) for n, s, k in _wide_selectors(TS)}[name]
    jsel = {n: s for n, s, _ in _wide_selectors(JS)}[name]
    got, t_kind = _dispatch(t, T.DISPATCH_STATS, tsel)
    want, j_kind = _dispatch(j, J.DISPATCH_STATS, jsel)
    assert t_kind == j_kind == {kind}
    assert_same_dist(got, want, rtol=RTOL)
    _dict_close(got.to_assoc().to_dict(), host[tsel].to_dict())


# ---------------------------------------------------------------------------
# the lazy pipelines, row reduction, assignment (tests/test_expr.py)
# ---------------------------------------------------------------------------

def _triples(seed, n=60, nr=30, nc=30):
    r = np.random.default_rng(seed)
    return (r.integers(0, nr, n).astype(str),
            r.integers(0, nc, n).astype(str), r.uniform(0.5, 5.0, n))


@pytest.fixture(scope="module")
def expr_pair(jmesh):
    rows, cols, vals = _triples(3)
    t, j = _both(rows, cols, vals, jmesh, aggregate="sum")
    return t, j, T.Assoc(rows, cols, vals, aggregate="sum")


def test_parity_transpose_dist_ewise(expr_pair):
    t, j, host = expr_pair
    # the transpose gathers to a replicated device tensor
    tt, jt = t.lazy().T.collect(), j.lazy().T.collect()
    assert isinstance(tt, T.AssocTensor)
    assert int(tt.nnz) == int(jt.nnz)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    np.testing.assert_array_equal(tt.cols.numpy(), np.asarray(jt.cols))
    np.testing.assert_allclose(tt.vals.numpy(), np.asarray(jt.vals),
                               rtol=RTOL)
    _dict_close(tt.to_assoc().to_dict(), host.transpose().to_dict())
    got = (t.lazy() + t.lazy()).collect()
    assert_same_dist(got, (j.lazy() + j.lazy()).collect(), rtol=RTOL)
    _dict_close(got.to_assoc().to_dict(), (host + host).to_dict())


def test_dist_row_reduce(expr_pair):
    t, j, host = expr_pair
    np.testing.assert_allclose(t.row_reduce().numpy(),
                               np.asarray(j.row_reduce()), rtol=RTOL_REDUCE)
    want = {k[0]: v for k, v in host.sum(axis=1).to_dict().items()}
    got = dict(zip(t.local.row_space.keys.tolist(),
                   t.row_reduce().tolist()))
    _dict_close(got, want, rtol=RTOL_REDUCE)


@pytest.mark.parametrize("axis", [0, 1, None])
def test_lazy_sums_and_fused_add_reduce(expr_pair, axis):
    """``D.lazy().sum(axis)`` and the fused ``(D ⊕ D).sum(axis)``
    (Reduce through EwiseAdd: one collective) against JAX."""
    t, j, _ = expr_pair
    for tx, jx in ((t.lazy(), j.lazy()),
                   (t.lazy() + t.lazy(), j.lazy() + j.lazy())):
        T.reset_collective_stats()
        got = tx.sum(axis=axis).collect()
        assert collective_count() == 1
        np.testing.assert_allclose(np.asarray(got), np.asarray(
            jx.sum(axis=axis).collect()), rtol=RTOL_REDUCE)


def test_fused_select_add(expr_pair):
    """``(A[s1] ⊕ A[s2])`` folds both selections into one shard-local merge
    (no collective)."""
    t, j, _ = expr_pair
    r1, r2 = TS.Range("1", "3"), TS.StartsWith("2,5,")
    got = (t.lazy()[r1, :] + t.lazy()[r2, :]).collect()
    assert collective_count() == 0 and T.PLAN_STATS["fused_select_ewise"] == 1
    want = (j.lazy()[JS.Range("1", "3"), :]
            + j.lazy()[JS.StartsWith("2,5,"), :]).collect()
    assert_same_dist(got, want, rtol=RTOL)


def test_dist_setitem_parity(jmesh):
    rows, cols, vals = _triples(11)
    t, j = _both(rows, cols, vals, jmesh, aggregate="sum")
    t[TS.Range("1", "3"), :] = 9.0
    j[JS.Range("1", "3"), :] = 9.0
    assert_same_dist(t, j, rtol=RTOL)
    t[TS.Mask(np.arange(len(t.local.row_space)) % 3 == 0), :] = 2.5
    j[JS.Mask(np.arange(len(j.local.row_space)) % 3 == 0), :] = 2.5
    assert_same_dist(t, j, rtol=RTOL)
    with pytest.raises(TypeError):
        t[TS.Range("1", "3"), :] = "nope"
    with pytest.raises(TypeError):
        t[TS.Range("1", "3"), :] = True


# ---------------------------------------------------------------------------
# element-wise algebra and reductions under every semiring (integer values:
# exact)
# ---------------------------------------------------------------------------

def _int_triples(seed, n=80):
    r = np.random.default_rng(seed)
    rows = np.char.zfill(r.integers(0, 25, n).astype(str), 2)
    cols = np.char.zfill(r.integers(0, 15, n).astype(str), 2)
    return rows, cols, r.integers(1, 10, n).astype(np.float64)


@pytest.fixture(scope="module")
def int_pair(jmesh):
    rows, cols, vals = _int_triples(5)
    # B on the same keys (a permutation), so its keyspaces equal A's
    r = np.random.default_rng(6)
    ta, ja = _both(rows, cols, vals, jmesh, aggregate="sum")
    tb, jb = _both(r.permutation(rows), r.permutation(cols),
                   r.integers(1, 10, len(rows)).astype(np.float64), jmesh,
                   aggregate="sum")
    return ta, ja, tb, jb


@pytest.mark.parametrize("sr", sorted(T.REGISTRY))
def test_ewise_parity(int_pair, sr):
    ta, ja, tb, jb = int_pair
    assert_same_dist(ta.add(tb, sr), ja.add(jb, sr))
    assert_same_dist(ta.mul(tb, sr), ja.mul(jb, sr))
    assert collective_count() == 0


@pytest.mark.parametrize("sr", sorted(T.REGISTRY))
def test_reduce_parity(int_pair, sr):
    ta, ja, _, _ = int_pair
    np.testing.assert_array_equal(ta.col_reduce(sr).numpy(),
                                  np.asarray(ja.col_reduce(sr)))
    np.testing.assert_array_equal(ta.row_reduce(sr).numpy(),
                                  np.asarray(ja.row_reduce(sr)))
    x = (np.arange(len(ta.local.col_space)) % 5 + 1).astype(np.float32)
    got = ta.matmul_dense_vec(torch.from_numpy(x), sr)
    want = ja.matmul_dense_vec(jnp.asarray(x), sr)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert COLLECTIVE_STATS == {"all_reduce": 3, "all_gather": 0,
                                "all_to_all": 0, "ring_shift": 0}


def test_col_degree_and_operators(int_pair):
    ta, ja, tb, jb = int_pair
    got = ta.col_degree()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja.col_degree()))
    assert_same_dist(ta + tb, ja + jb)
    assert_same_dist(ta * tb, ja * jb)


def test_gather_replicated_keeps_stored_zero():
    """A stored 0.0 (under MIN_PLUS, ⊗ = + of 1 and -1) survives the gather:
    no zero-drop, as the JAX docstring requires."""
    rows, cols = np.asarray(["a", "b", "c"]), np.asarray(["x", "y", "x"])
    ta = DistAssoc.from_triples(rows, cols, [1.0, 2.0, 3.0], cpu_mesh(),
                                device="cpu")
    tb = DistAssoc.from_triples(rows, cols, [-1.0, 5.0, 3.0], cpu_mesh(),
                                device="cpu")
    got = ta.mul(tb, "min_plus").gather_replicated()
    assert int(got.nnz) == 3
    np.testing.assert_array_equal(got.vals.numpy()[:3], [0.0, 7.0, 6.0])
    assert COLLECTIVE_STATS["all_gather"] == 1


def test_from_assoc_to_assoc_and_convert(jmesh):
    rows, cols, vals = _int_triples(9)
    host = T.Assoc(rows, cols, vals)
    t = DistAssoc.from_assoc(host, cpu_mesh(), device="cpu")
    j = JDist.from_assoc(J.Assoc(rows, cols, vals), jmesh)
    assert_same_dist(t, j)
    assert t.to_assoc() == host
    # the numpy form of the JAX state, shard by shard, and back
    jl = j.local
    t2 = convert.from_jax_dist_state(
        np.asarray(jl.rows), np.asarray(jl.cols), np.asarray(jl.vals),
        np.asarray(jl.nnz), jl.row_space.keys, jl.col_space.keys,
        j.row_bounds, cpu_mesh())
    assert_same_dist(t2, j)
    st = convert.to_numpy_dist_state(t2)
    assert st["rank"] == 0 and st["nnz"] == int(np.asarray(jl.nnz)[0])
    np.testing.assert_array_equal(st["rows"], np.asarray(jl.rows)[0])
    np.testing.assert_array_equal(st["row_bounds"], j.row_bounds)
    with pytest.raises(ValueError, match="shards"):
        convert.from_jax_dist_state(
            np.stack([jl.rows[0]] * 2), np.stack([jl.cols[0]] * 2),
            np.stack([jl.vals[0]] * 2), np.asarray([1, 1]),
            jl.row_space.keys, jl.col_space.keys, [0, 1, 2], cpu_mesh())


def test_string_values(jmesh):
    """String values share one value keyspace over all shards."""
    t, j = _both(["a", "b", "c"], ["x", "y", "x"], ["u", "w", "v"], jmesh)
    assert_same_dist(t, j)
    assert t.to_assoc().to_dict() == {("a", "x"): "u", ("b", "y"): "w",
                                      ("c", "x"): "v"}
    with pytest.raises(TypeError, match="numeric"):
        t[":", ":"] = 1.0


# ---------------------------------------------------------------------------
# contracts: the collectives of each entry point equal the JAX @contract
# ---------------------------------------------------------------------------

def _jax_collectives(fn) -> int:
    return getattr(fn, CONTRACT_ATTR).collectives


@pytest.mark.parametrize("entry", ["add", "mul", "__getitem__",
                                   "__setitem__", "col_reduce", "row_reduce",
                                   "col_degree", "matmul_dense_vec"])
def test_collectives_match_jax_contract(int_pair, entry):
    ta, _, tb, _ = int_pair
    x = torch.ones(len(ta.local.col_space))
    sel = (TS.Range("03", "11"), ":")
    copy = DistAssoc(ta.local, ta.mesh, row_bounds=ta.row_bounds)
    calls = {"add": lambda: ta.add(tb), "mul": lambda: ta.mul(tb),
             "__getitem__": lambda: ta[sel],
             "__setitem__": lambda: copy.__setitem__(sel, 3.0),
             "col_reduce": ta.col_reduce, "row_reduce": ta.row_reduce,
             "col_degree": ta.col_degree,
             "matmul_dense_vec": lambda: ta.matmul_dense_vec(x)}
    T.reset_collective_stats()
    calls[entry]()
    assert collective_count() == _jax_collectives(getattr(JDist, entry))


# ---------------------------------------------------------------------------
# devices and operands
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    """Without ``device=`` the constructors ask for the card: here (no card)
    that raises, and on a card a CPU mesh refuses it."""
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        DistAssoc.from_triples(["a"], ["x"], [1.0], cpu_mesh())
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        DistAssoc.from_assoc(T.Assoc(["a"], ["x"], [1.0]), cpu_mesh())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.make_mesh()


def test_cpu_mesh_refuses_cuda_tensors():
    """A gloo group cannot carry CUDA tensors: the mesh refuses such a
    device, and a tensor off the mesh's device raises in a collective."""
    mesh = cpu_mesh()
    assert mesh.backend == "gloo" and mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="gloo"):
        Mesh(mesh.group, 0, 1, torch.device("cuda", 0), "gloo")
    off = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        T.collectives.mesh_combine(off, mesh, T.PLUS_TIMES)
    with pytest.raises(ValueError, match="meta"):
        T.collectives.all_gather(off, mesh)
    t = DistAssoc.from_triples(["a"], ["x"], [1.0], mesh, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        t.matmul_dense_vec(torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="store_path"):
        T.make_mesh("cpu", world_size=2)


def test_ewise_operands_must_share_keyspaces(int_pair):
    ta, _, _, _ = int_pair
    with pytest.raises(ValueError, match="keyspaces"):
        ta.add(DistAssoc.from_triples(["zz"], ["zz"], [1.0], ta.mesh,
                                      device="cpu"))


def test_device_matmul_gathers_a_dist_operand(int_pair):
    """A device A against a dist B: B gathers to a replicated tensor, as the
    JAX planner does (held against the host product, as the dist
    products are in ``tests/test_torch_dist_matmul.py``)."""
    ta, _, tb, _ = int_pair
    got = (ta.gather_replicated().lazy() @ tb.lazy()).collect()
    assert got.to_assoc() == ta.to_assoc() @ tb.to_assoc()


def test_dist_main_path_small():
    """The dist slice of the main path at clustered n=10 on the CPU: every
    result equals the host Assoc and the device result, and each op makes
    its contract's collectives."""
    mesh = cpu_mesh()
    clus = main_path.build_clustered(10, "cpu")
    d = main_path.build_dist(clus["raw"], mesh, "cpu")
    drv = main_path.drive_dist(d["A"], d["B"], clus["A"], clus["B"],
                               main_path.row_range(clus["A"]))
    checks = main_path.check_dist(clus["raw"], drv)
    assert len(checks) == 41
    assert all(ok for _, ok, _ in checks), [c for c in checks if not c[1]]
    assert int(drv["dist"]["select"].local.nnz) > 0


# ---------------------------------------------------------------------------
# four ranks against the JAX package on four host devices
# ---------------------------------------------------------------------------

# the same triples in both programs: A and B on the same keys (B's are a
# permutation of A's), integer values
_DATA = """
import numpy as np
rng = np.random.default_rng(19)
N = 240
ROWS = np.char.zfill(rng.integers(0, 40, N).astype(str), 3)
COLS = np.char.zfill(rng.integers(0, 24, N).astype(str), 3)
VALS = rng.integers(1, 10, N).astype(np.float64)
ROWS_B, COLS_B = rng.permutation(ROWS), rng.permutation(COLS)
VALS_B = rng.integers(1, 10, N).astype(np.float64)
RK, CK = np.unique(ROWS), np.unique(COLS)
X = (np.arange(len(CK)) % 5 + 1).astype(np.float32)
# one row in each shard; column c0 holds a NaN in shard 1's partial,
# column c1 in shard 0's, column c2 in every shard's
NAN_ROWS = np.asarray(["r0", "r1", "r2", "r3"] * 3)
NAN_COLS = np.asarray(["c0"] * 4 + ["c1"] * 4 + ["c2"] * 4)
NAN_VALS = np.asarray([1.0, np.nan, 1.0, 1.0, np.nan, 1.0, 1.0, 1.0]
                      + [np.nan] * 4)
SEMIRINGS = ("and_or", "max_min", "max_plus", "max_times", "min_plus",
             "plus_times")
"""

# every op, in both packages: ``build``, ``put_d``, ``put_v``, ``vec`` and
# the selector names come from the program around it
_OPS = """
A = build(ROWS, COLS, VALS)
B = build(ROWS_B, COLS_B, VALS_B)
put_d("A", A)
put_d("B", B)
SELS = {
    "range": (Range(RK[5], RK[20]), All()),
    "empty_shard": (Range(RK[0], RK[len(RK) * 6 // 10]), All()),
    "multi": (Keys(list(RK[2:5]) + list(RK[30:33])), All()),
    "hybrid": (Keys(list(RK[::3])), All()),
    "gather": (Keys(list(RK[::3])), Keys(list(CK[::2]))),
    "cols": (All(), Range(CK[3], CK[12])),
}
for k, (i, j) in SELS.items():
    put_d("sel_" + k, A[i, j])
for s in SEMIRINGS:
    put_d("add_" + s, A.add(B, s))
    put_d("mul_" + s, A.mul(B, s))
    put_v("colred_" + s, A.col_reduce(s))
    put_v("rowred_" + s, A.row_reduce(s))
    put_v("matvec_" + s, A.matmul_dense_vec(vec(X), s))
put_v("coldeg", A.col_degree())
put_d("op_add", A + B)
put_d("op_mul", A * B)
S = DistAssoc(A.local, A.mesh, row_bounds=A.row_bounds)
S[SELS["range"]] = 7.0
put_d("set_range", S)
S[Mask(np.arange(len(RK)) % 3 == 0), All()] = 2.5
put_d("set_mask", S)
put_d("lazy_sel_add", (A.lazy()[SELS["range"][0], :]
                       + B.lazy()[SELS["multi"][0], :]).collect())
put_v("lazy_sum", (A.lazy() + B.lazy()).sum(axis=1).collect())
C = build(NAN_ROWS, NAN_COLS, NAN_VALS, "max")
put_d("nan", C)
put_v("nan_colred", C.col_reduce("max_plus"))
"""

_JAX_PROG = _DATA + """
import sys
import jax
import jax.numpy as jnp
from repro.core.dist_assoc import DistAssoc
from repro.core.select import All, Keys, Mask, Range
assert jax.device_count() == 4
mesh = jax.make_mesh((4,), ("data",))
out = {}
def build(r, c, v, agg="sum"):
    return DistAssoc.from_triples(r, c, v, mesh, aggregate=agg)
def put_d(name, d):
    for f in ("rows", "cols", "vals", "nnz"):
        out[name + "__" + f] = np.asarray(getattr(d.local, f))
    out[name + "__bounds"] = np.asarray(d.row_bounds)
def put_v(name, v):
    out[name + "__vec"] = np.asarray(v)
def vec(x):
    return jnp.asarray(x)
""" + _OPS + """
np.savez(sys.argv[1], **out)
"""

_PORT_PROG = _DATA + """
from repro_torch.core import Assoc, DistAssoc
from repro_torch.core.select import All, Keys, Mask, Range
out = {}
def build(r, c, v, agg="sum"):
    return DistAssoc.from_triples(r, c, v, mesh, aggregate=agg, device="cpu")
def put_d(name, d):
    for f in ("rows", "cols", "vals", "nnz"):
        out[name + "__" + f] = getattr(d.local, f).numpy()
    out[name + "__bounds"] = np.asarray(d.row_bounds)
def put_v(name, v):
    out[name + "__vec"] = v.numpy()
def vec(x):
    return torch.from_numpy(x)
""" + _OPS + """
# what the JAX package cannot run at four shards, as key triples
def keys_of(t):
    n = int(t.nnz)
    return (t.row_space.keys[t.rows[:n].numpy()],
            t.col_space.keys[t.cols[:n].numpy()], t.vals[:n].numpy())
for name, t in (("gather", A.gather_replicated()),
                ("lazy_T", A.lazy().T.collect())):
    for f, x in zip(("rows", "cols", "vals"), keys_of(t)):
        out[name + "__k" + f] = x
for f, x in zip(("rows", "cols", "vals"), A.to_assoc().triples()):
    out["to_assoc__k" + f] = x
np.savez(OUT, **out)
"""

SHARD_OPS = (["A", "B", "op_add", "op_mul", "set_range", "set_mask",
              "lazy_sel_add", "nan"]
             + [f"sel_{k}" for k in ("range", "empty_shard", "multi",
                                     "hybrid", "gather", "cols")]
             + [f"{op}_{s}" for op in ("add", "mul")
                for s in sorted(T.REGISTRY)])
VECTOR_OPS = (["coldeg", "lazy_sum"]
              + [f"{op}_{s}" for op in ("colred", "rowred", "matvec")
                 for s in sorted(T.REGISTRY)])


@pytest.fixture(scope="module", autouse=True)
def _four_started(tmp_path_factory):
    """The JAX process and the four ranks, started before the module's
    first test and stopped after its last."""
    run = SpmdRun(_JAX_PROG, _PORT_PROG, tmp_path_factory.mktemp("dist4"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def four(_four_started):
    return _four_started.result()


@pytest.mark.parametrize("op", SHARD_OPS)
def test_four_ranks_shards_equal_jax(four, op):
    jx, ranks = four
    for r, got in enumerate(ranks):
        for f in ("rows", "cols", "vals", "nnz"):
            np.testing.assert_array_equal(got[f"{op}__{f}"],
                                          jx[f"{op}__{f}"][r], err_msg=f)
        np.testing.assert_array_equal(got[f"{op}__bounds"],
                                      jx[f"{op}__bounds"])


@pytest.mark.parametrize("op", VECTOR_OPS)
def test_four_ranks_reductions_equal_jax(four, op):
    jx, ranks = four
    for got in ranks:
        assert got[f"{op}__vec"].dtype == jx[f"{op}__vec"].dtype
        np.testing.assert_array_equal(got[f"{op}__vec"], jx[f"{op}__vec"])


def test_four_ranks_empty_shard_and_nan_combine(four):
    """The selection that leaves shard 3 empty; the MAX_PLUS combine of
    partials [1, NaN, 1, 1] (column c0), [NaN, 1, 1, 1] (column c1) and
    NaN on every shard (column c2): JAX's pmax at four shards treats a NaN
    partial as absent (1, 1 and the ⊕ identity -inf), and so does the
    port's combine on rank 0's NaN as on rank 1's."""
    jx, ranks = four
    assert ranks[3]["sel_empty_shard__nnz"] == 0
    assert jx["sel_empty_shard__nnz"][3] == 0
    assert np.isnan(ranks[1]["nan__vals"][0])
    np.testing.assert_array_equal(jx["nan_colred__vec"], [1.0, 1.0, -np.inf])
    for got in ranks:
        np.testing.assert_array_equal(got["nan_colred__vec"],
                                      jx["nan_colred__vec"])


def test_one_rank_nan_combine(jmesh):
    """At one shard the JAX combine is the identity and NaN stays: so it
    does at one rank."""
    ns = {}
    exec(_DATA, ns)
    t, j = _both(ns["NAN_ROWS"], ns["NAN_COLS"], ns["NAN_VALS"], jmesh,
                 aggregate="max")
    want = np.asarray(j.col_reduce("max_plus"))
    assert np.isnan(want).all()
    np.testing.assert_array_equal(t.col_reduce("max_plus").numpy(), want)


@pytest.mark.parametrize("what", ["gather", "lazy_T", "to_assoc"])
def test_four_ranks_gathers_equal_host(four, what):
    """``gather_replicated``, lazy ``.T`` and ``to_assoc`` (JAX raises on
    them at four shards): every rank holds all of A, as the host does."""
    _, ranks = four
    ns = {}
    exec(_DATA, ns)
    host = T.Assoc(ns["ROWS"], ns["COLS"], ns["VALS"], aggregate="sum")
    if what == "lazy_T":
        host = host.transpose()
    coo = host.adj.tocoo()
    order = np.lexsort((coo.col, coo.row))
    want = (host.row[coo.row[order]], host.col[coo.col[order]],
            coo.data[order])
    for got in ranks:
        for f, w in zip(("rows", "cols", "vals"), want):
            np.testing.assert_array_equal(got[f"{what}__k{f}"], w)
