"""The whole slice end to end on the CPU: the main path that
``chip_smoke.py`` drives on the card (``repro_torch.main_path``), at small
sizes, through the port AND the JAX package on the same triples — every
result, ``DISPATCH_STATS`` and ``PLAN_STATS`` must agree — and against the
host ``Assoc`` checks the smoke run applies."""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch import main_path
from repro_torch.configs.d4m_bench import make_clustered, make_dataset
from repro_torch.core import spgemm as tsp

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            assert_same, assert_same_tensor)

N_CLUSTERED = 10   # 8k triples per array: the planner picks bsr
N_UNIFORM = 8      # 2k triples over 256 keys: the planner picks dense
                   # for A @ B, sqout(reduce=1) and matmul_reduce


def _jax_clustered(raw, sel_keys):
    """The JAX package's results on the clustered arrays.  Its eager ops
    compile one program each and XLA compiles with the GIL released, so
    the two arrays are built, and then the five results computed, side by
    side on threads."""
    from concurrent.futures import ThreadPoolExecutor
    rows, cols, rows2, cols2 = raw
    ones = np.ones(len(rows))
    cap = int(np.ceil(len(rows) / 8) * 8)
    sel = J.Range(*sel_keys)
    with ThreadPoolExecutor(5) as ex:
        fa, fb = (ex.submit(J.AssocTensor.from_triples, r, c, ones,
                            capacity=cap)
                  for r, c in ((rows, cols), (rows2, cols2)))
        a, b = fa.result(), fb.result()
        jobs = {"select": lambda: a[sel, :], "add": lambda: a + b,
                "matmul": lambda: a @ b,
                "sqout_reduce": lambda: a.sqout(reduce=1),
                "pipeline": lambda: (a.lazy()[sel, :] @ b.lazy()).sum(
                    axis=1).collect()}
        futures = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def test_generators_match_the_reference_benchmarks():
    """The port's copies of the workload generators draw what the JAX
    package's benchmarks draw."""
    from benchmarks.paper_benchmarks import _matmul_setup
    from repro.configs.d4m_bench import make_dataset as j_make_dataset
    rows, cols, rows2, cols2 = make_clustered(9)
    host_a, host_b, _, _ = _matmul_setup(9, "sparse")
    assert host_a == J.Assoc(rows, cols, 1.0)
    assert host_b == J.Assoc(rows2, cols2, 1.0)
    for k, v in make_dataset(7).items():
        np.testing.assert_array_equal(v, j_make_dataset(7)[k])


def test_clustered_main_path_matches_jax_and_host():
    c = main_path.build_clustered(N_CLUSTERED, "cpu")
    res = main_path.drive_clustered(c["A"], c["B"])
    sel = res["selector"]
    want = _jax_clustered(c["raw"], (sel.lo, sel.hi))
    for k in ("select", "add", "matmul"):
        assert_same_tensor(res[k], want[k], floats=False)
    for k in ("sqout_reduce", "pipeline"):
        assert_same(res[k], want[k], floats=False)
    assert T.DISPATCH_STATS == J.DISPATCH_STATS
    assert T.DISPATCH_STATS["range"] == 1
    assert T.PLAN_STATS == {k: J.PLAN_STATS[k] for k in T.PLAN_STATS}
    assert T.PLAN_STATS["fused_matmul_reduce"] >= 1
    assert T.PLAN_STATS["fused_select_matmul"] == 1
    for name, ok, detail in main_path.check_clustered(c["raw"], res,
                                                      full=True):
        assert ok, (name, detail)
    for name, ok, detail in main_path.check_clustered(c["raw"], res,
                                                      full=False):
        assert ok, (name, detail)


def test_uniform_main_path_matches_jax_and_host():
    from concurrent.futures import ThreadPoolExecutor
    u = main_path.build_uniform(N_UNIFORM, "cpu")
    res = main_path.drive_uniform(u["A"], u["B"])
    rows, cols, rows2, cols2, vals = u["raw"]
    sel = J.Range(res["selector"].lo, res["selector"].hi)
    # the JAX side's programs compile side by side (GIL released)
    with ThreadPoolExecutor(5) as ex:
        fa, fb = (ex.submit(J.AssocTensor.from_triples, r, c, vals)
                  for r, c in ((rows, cols), (rows2, cols2)))
        ja, jb = fa.result(), fb.result()
        want = {k: ex.submit(f) for k, f in {
            "plus_times": lambda: ja.matmul(jb, J.PLUS_TIMES),
            "min_plus": lambda: ja.matmul(jb, J.MIN_PLUS),
            "sqout_reduce": lambda: ja.sqout(reduce=1),
            "matmul_reduce0": lambda: ja.matmul_reduce(jb, axis=0),
            "pipeline": lambda: (ja.lazy()[sel, :] @ jb.lazy()).sum(
                axis=1).collect()}.items()}
        want = {k: f.result() for k, f in want.items()}
    assert_same_tensor(res["plus_times"], want["plus_times"], floats=False)
    assert_same_tensor(res["min_plus"], want["min_plus"], floats=False)
    for k in ("sqout_reduce", "matmul_reduce0", "pipeline"):
        assert_same(res[k], want[k], floats=False)
    assert T.PLAN_STATS == {k: J.PLAN_STATS[k] for k in T.PLAN_STATS}
    for name, ok, detail in main_path.check_uniform(u["raw"], res):
        assert ok, (name, detail)


@pytest.mark.parametrize("which,n,impl", [("clustered", N_CLUSTERED, "bsr"),
                                          ("uniform", N_UNIFORM, "dense")])
def test_planner_picks_the_slice_strategies(which, n, impl):
    build = (main_path.build_clustered if which == "clustered"
             else main_path.build_uniform)
    d = build(n, "cpu")
    a, b, ks = tsp._contraction_aligned(d["A"], d["B"], T.PLUS_TIMES)
    ra, ca, _ = tsp._valid_host(a)
    rb, cb, _ = tsp._valid_host(b)
    plan = tsp.plan_matmul(ra, ca, rb, cb, len(a.row_space), len(ks),
                           len(b.col_space))
    assert plan.impl == impl


def test_planner_picks_dense_for_the_uniform_reduces_at_n12():
    """At the paper's uniform n=12 (the chip run's size) the fused reduces
    of the main path — ``A.sqout(reduce=1)`` (A ⊗.⊕ Aᵀ) and
    ``A.matmul_reduce(B)`` — plan ``dense``, so they run the block-masked
    ``bsr_spgemm_reduce`` kernel on the card (planning only, no product)."""
    u = main_path.build_uniform(12, "cpu")
    for b in (u["A"].transpose(), u["B"]):
        a, b, ks = tsp._contraction_aligned(u["A"], b, T.PLUS_TIMES)
        ra, ca, _ = tsp._valid_host(a)
        rb, cb, _ = tsp._valid_host(b)
        plan = tsp.plan_matmul(ra, ca, rb, cb, len(a.row_space), len(ks),
                               len(b.col_space))
        assert plan.impl == "dense"
