"""The port's sharded products (``DistAssoc.matmul``/``matmul_reduce``/
``sqout``/``sqin``/``@`` and the lazy dist product) against the JAX package.

The JAX ``DistAssoc`` products raise on this jax (their host prologue
``_matmul_setup`` does), so the port is held to what does run there:

* the host cost model, ``plan_dist_matmul`` and ``suggest_grid``, field by
  field on the synthetic cases of ``tests/test_dist_spgemm.py`` and on
  seeded random inputs, also through the per-rank summaries;
* ``bucket_coo_by_range`` and the packing of triples for a collective;
* the JAX shard programs themselves, called with staged inputs built here
  in numpy (what ``_matmul_setup`` gives): at one shard in this process,
  and at four shards in one JAX process on four host devices beside four
  port ranks on one gloo group, shard by shard;
* end to end, every strategy against the host ``Assoc`` at one rank (this
  process) and at four ranks, with the collectives each entry point makes
  (program collectives against the JAX ``@contract``, prologue
  collectives against the table in ``repro_torch.core.dist_assoc``), and
  the strategy ``auto_dist`` picks against the JAX plan on the same
  inputs.

Tolerances: ranks, ``nnz``, plan fields, collective counts and values from
integer inputs are exact; the float fixtures of ``tests/test_dist_spgemm.py``
(``uniform(0.5, 3.0)``) compare at ``rtol=1e-4``, ``atol=1e-4``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core.dist_assoc as JD
import repro.core.spgemm as JS
import repro_torch.core as T
import repro_torch.core.dist_assoc as TD
import repro_torch.core.spgemm as TSP
from repro.analysis.contracts import CONTRACT_ATTR
from repro.core.coo import bucket_coo_by_range as j_bucket
from repro_torch.core.collectives import COLLECTIVE_STATS, PROLOGUE_STATS
from repro_torch.core.coo import SENT, bucket_coo_by_range

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            SpmdRun, cpu_mesh)

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _free_jax_programs():
    """Free the XLA programs this module compiled when it ends."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# the cost model (host only)
# ---------------------------------------------------------------------------

def _synthetic(P=4, cap=8, k=16, nnz_per_shard=3, nnz_b=20, seed=0):
    """The inputs of ``tests/test_dist_spgemm.py``'s cost-model tests."""
    r = np.random.default_rng(seed)
    a_rows = np.full((P, cap), int(SENT), np.int64)
    a_cols = np.zeros((P, cap), np.int64)
    counts = np.zeros((P, cap), np.int64)
    for s in range(P):
        a_rows[s, :nnz_per_shard] = np.arange(nnz_per_shard)
        a_cols[s, :nnz_per_shard] = r.integers(0, k, nnz_per_shard)
        counts[s, :nnz_per_shard] = r.integers(1, 4, nnz_per_shard)
    b_rows = np.sort(r.integers(0, k, nnz_b))
    return a_rows, a_cols, counts, b_rows, k


def _random_inputs(P, seed):
    """Seeded ragged ``[P, cap]`` inputs with SENT padding, a shard left
    empty when P > 2, and B's sorted contraction ranks."""
    r = np.random.default_rng(seed)
    cap, k = 24, 40
    a_rows = np.full((P, cap), int(SENT), np.int64)
    a_cols = np.full((P, cap), int(SENT), np.int64)
    counts = np.zeros((P, cap), np.int64)
    b_rows = np.sort(r.integers(0, k, 300))
    for s in range(P):
        n = 0 if (P > 2 and s == 1) else int(r.integers(1, cap + 1))
        a_rows[s, :n] = np.sort(r.integers(0, 50, n))
        a_cols[s, :n] = r.integers(0, k, n)
        counts[s, :n] = (np.searchsorted(b_rows, a_cols[s, :n], "right")
                         - np.searchsorted(b_rows, a_cols[s, :n], "left"))
    return a_rows, a_cols, counts, b_rows, k


def _same_plan(got, want):
    for f in ("strategy", "grid", "bucket_cap", "block_cap", "expands",
              "costs"):
        assert getattr(got, f) == getattr(want, f), f


def _both_plans(args, P, **kw):
    return (TSP.plan_dist_matmul(*args, P, **kw),
            JS.plan_dist_matmul(*args, P, **kw))


def _summary_plan(args, P, b_resident=False, grid=None, a2a_bounds=None):
    """The SPMD route: every rank's summary, stacked, then one plan."""
    a_rows, a_cols, counts, b_rows, k = args
    rows = [TSP.dist_summary(a_rows[s], a_cols[s], counts[s], k, P,
                             grid=grid, a2a_bounds=a2a_bounds)
            for s in range(P)]
    return TSP.plan_from_summaries(np.stack(rows), b_rows, k, P,
                                   b_resident=b_resident, grid=grid)


def test_cost_model_single_shard():
    args = _synthetic(P=1)
    got, want = _both_plans(args, 1)
    _same_plan(got, want)
    assert got.strategy == "replicate"


def test_cost_model_large_b():
    a_rows, a_cols, counts, _, k = _synthetic(P=8, nnz_per_shard=2)
    b_rows = np.sort(np.random.default_rng(11).integers(0, k, 100_000))
    args = (a_rows, a_cols, counts, b_rows, k)
    got, want = _both_plans(args, 8, b_resident=True)
    _same_plan(got, want)
    assert got.strategy in ("all_to_all", "2d")
    _same_plan(_summary_plan(args, 8, b_resident=True), want)


def test_cost_model_resident_b():
    args = _synthetic(P=4, nnz_b=50)
    for res in (True, False):
        got, want = _both_plans(args, 4, b_resident=res)
        _same_plan(got, want)
    res, staged = (TSP.plan_dist_matmul(*args, 4, b_resident=b)
                   for b in (True, False))
    assert staged.costs["all_to_all"] - res.costs["all_to_all"] == 50


def test_cost_model_forced_grid():
    args = _synthetic(P=4)
    got, want = _both_plans(args, 4, grid=(2, 2))
    _same_plan(got, want)
    assert got.grid == (2, 2)
    _same_plan(_summary_plan(args, 4, grid=(2, 2)), want)
    for fn in (TSP.plan_dist_matmul, JS.plan_dist_matmul):
        with pytest.raises(ValueError, match="does not tile"):
            fn(*args, 4, grid=(3, 2))
    with pytest.raises(ValueError, match="does not tile"):
        TSP.dist_summary(*args[:3], args[4], 4, grid=(3, 2))


def test_suggest_grid_sizes_blocks():
    a_rows, a_cols, counts, b_rows, k = _synthetic(P=8, nnz_b=64)
    got = TSP.suggest_grid(8, k, a_cols, counts, b_rows)
    want = JS.suggest_grid(8, k, a_cols, counts, b_rows)
    assert got == want
    (pr, pc), round_expand, block_cap, cost = got
    assert pr * pc == 8 and round_expand >= 8 and block_cap >= 8


@pytest.mark.parametrize("P", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_model_random(P, seed):
    """Random ragged inputs, staged and resident B (with its own partition
    for the all-to-all table) and every grid that tiles P: the port's plan
    equals JAX's field by field, directly and through the per-rank
    summaries."""
    args = _random_inputs(P, seed)
    a2a = np.sort(np.random.default_rng(seed).integers(0, args[4], P + 1))
    a2a[0], a2a[-1] = 0, args[4]
    cases = [dict(), dict(b_resident=True, a2a_bounds=a2a)]
    cases += [dict(grid=(P // pc, pc)) for pc in JS._divisors(P)]
    for kw in cases:
        got, want = _both_plans(args, P, **kw)
        _same_plan(got, want)
        _same_plan(_summary_plan(args, P, **kw), want)
    a_rows, a_cols, counts, b_rows, k = args
    assert (TSP.suggest_grid(P, k, a_cols, counts, b_rows)
            == JS.suggest_grid(P, k, a_cols, counts, b_rows))


# ---------------------------------------------------------------------------
# bucket_coo_by_range and the pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket_cap", [2, 5, 64])
def test_bucket_coo_by_range(bucket_cap):
    """Ragged buckets, SENT entries among the triples, and (at small
    ``bucket_cap``) bucket overflow dropped, as JAX drops it."""
    r = np.random.default_rng(bucket_cap)
    rows = r.integers(0, 30, 50).astype(np.int32)
    rows[r.random(50) < 0.2] = SENT
    cols = r.integers(0, 9, 50).astype(np.int32)
    vals = r.integers(1, 9, 50).astype(np.float32)
    bounds = np.asarray([0, 3, 3, 17, 30], np.int32)   # bucket 1 is empty
    got = bucket_coo_by_range(torch.from_numpy(rows), torch.from_numpy(cols),
                              torch.from_numpy(vals),
                              torch.from_numpy(bounds), 4, bucket_cap,
                              zero=-np.inf)
    want = j_bucket(rows, cols, vals, bounds, 4, bucket_cap, zero=-np.inf)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4, bucket_cap)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_round_trips_bits():
    vals = np.asarray([np.nan, -0.0, np.inf, -np.inf, 1.5, 0.0], np.float32)
    rows = np.arange(6, dtype=np.int32)
    cols = np.full(6, SENT, np.int32)
    packed = TD._pack_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JD._pack_coo(rows, cols, vals)))
    r, c, v = TD._unpack_coo(packed)
    np.testing.assert_array_equal(r.numpy(), rows)
    np.testing.assert_array_equal(c.numpy(), cols)
    assert v.numpy().view(np.int32).tolist() == vals.view(np.int32).tolist()


# ---------------------------------------------------------------------------
# the shard programs on staged inputs: numpy staging shared by this
# process, the JAX process and the port ranks
# ---------------------------------------------------------------------------

_STAGE = """
import numpy as np
SENT = 2 ** 31 - 1
_r = np.random.default_rng(23)
# rank-space operands: A over m x k, B over k x n, integer values
M, K, N = 37, 29, 23
AR, AC = _r.integers(0, M, 140), _r.integers(0, K, 140)
AV = _r.integers(1, 6, 140).astype(np.float32)
BR, BC = _r.integers(0, K, 170), _r.integers(0, N, 170)
BV = _r.integers(1, 6, 170).astype(np.float32)
PROG_SEMIRINGS = ("plus_times", "min_plus")


def canon(r, c, v):
    key = r.astype(np.int64) * 2 ** 31 + c
    u, inv = np.unique(key, return_inverse=True)
    out = np.zeros(len(u), np.float32)
    np.add.at(out, inv, v)
    return (u // 2 ** 31).astype(np.int32), (u % 2 ** 31).astype(np.int32), out


def rnd8(x):
    return int(max(8, -(-max(int(x), 1) // 8) * 8))


def stage(P, nan=False):
    '''What _matmul_setup gives on P shards: A's [P, cap] shards (shard 1
    left empty when P > 1; with ``nan``, NaN values in shards 0 and 2),
    B's sorted replicated triples, the contraction blocks and one static
    size that bounds every program's buffers.'''
    ar, ac, av = canon(AR, AC, AV)
    br, bc, bv = canon(BR, BC, BV)
    bounds = np.linspace(0, M, P + 1).astype(np.int64)
    shard = np.searchsorted(bounds[1:], ar, side="right")
    if P > 1:
        keep = shard != 1
        ar, ac, av, shard = ar[keep], ac[keep], av[keep], shard[keep]
    cap = rnd8(np.bincount(shard, minlength=P).max())
    A = {f: np.full((P, cap), fill, dt) for f, fill, dt in
         (("rows", SENT, np.int32), ("cols", SENT, np.int32),
          ("vals", 0.0, np.float32))}
    for s in range(P):
        m = shard == s
        n = int(m.sum())
        A["rows"][s, :n], A["cols"][s, :n] = ar[m], ac[m]
        A["vals"][s, :n] = av[m]
        if nan and s in (0, 2) and n:
            A["vals"][s, n // 2] = np.nan
    counts = (np.searchsorted(br, ac, "right") - np.searchsorted(br, ac))
    size = rnd8(counts.sum())
    return dict(A=A, B=(br, bc, bv), bounds=bounds, size=size)


def blocks(st, P, nb, s):
    '''Shard s's B block of nb equal contraction ranges, padded to the
    largest block (B staged by range, as _a2a_b_operand and
    _stage_b_blocks stage it).'''
    br, bc, bv = st["B"]
    idx = np.searchsorted(br, np.linspace(0, K, nb + 1).astype(np.int64))
    cap = rnd8(np.diff(idx).max())
    lo, hi = idx[s % nb], idx[s % nb + 1]
    out = (np.full(cap, SENT, np.int32), np.full(cap, SENT, np.int32),
           np.zeros(cap, np.float32))
    out[0][:hi - lo], out[1][:hi - lo], out[2][:hi - lo] = \\
        br[lo:hi], bc[lo:hi], bv[lo:hi]
    return out


def grids(P):
    return [(P // pc, pc) for pc in range(1, P + 1) if P % pc == 0]


def program_names(P):
    names = []
    for s in PROG_SEMIRINGS:
        names += [f"{p}_{s}" for p in ("mm", "mr0", "mr1", "a2a", "ra0",
                                        "ra1", "bsr")]
        names += [f"ring{g[0]}x{g[1]}_{s}" for g in grids(P)]
    return names + ["nan_mr0_max_plus", "nan_mr1_max_plus",
                    "nan_ra1_max_plus"]
"""

# the JAX programs on P shards, called directly: each writes its output
# dict under its name into ``out`` (``mesh``, ``P`` from around it)
_JAX_PROGRAMS = """
import jax.numpy as jnp
from repro.core import dist_assoc as JD
from repro.core.semiring import get_semiring as jax_semiring
from repro.core.spgemm import TILE, pack_tiles, plan_matmul


def jax_programs(mesh, P, out):
    for nan in (False, True):
        st = stage(P, nan)
        A, (br, bc, bv), size = st["A"], st["B"], st["size"]
        bnd = st["bounds"].astype(np.int32)
        srs = ("max_plus",) if nan else PROG_SEMIRINGS
        for name in srs:
            sr = jax_semiring(name)
            tag = ("nan_" if nan else "") + "%s_" + name
            def put(key, o):
                if isinstance(o, dict):
                    for f, x in o.items():
                        out[tag % key + "__" + f] = np.asarray(x)
                else:
                    out[tag % key + "__vec"] = np.asarray(o)
            bst = [blocks(st, P, P, s) for s in range(P)]
            b_sh = {f: np.stack([b[i] for b in bst])
                    for i, f in enumerate(("rows", "cols", "vals"))}
            bm = np.arange(K, dtype=np.int32)
            flat = [A[f].reshape(-1) for f in ("rows", "cols", "vals")]
            for axis in (0, 1):
                n_out = M if axis == 1 else N
                put(f"mr{axis}", JD._matmul_reduce_prog(
                    mesh, sr, size, n_out, axis)(A, br, bc, bv))
                put(f"ra{axis}", JD._matmul_reduce_a2a_prog(
                    mesh, sr, size, n_out, axis)(*flat, b_sh, bm))
            if nan:
                continue
            put("mm", JD._matmul_prog(mesh, sr, size, size)(A, br, bc, bv))
            put("a2a", JD._matmul_a2a_prog(mesh, sr, size, size, size, P)(
                *flat, b_sh, bm, bnd))
            for pr, pc in grids(P):
                bl = [blocks(st, P, pc, s) for s in range(P)]
                put(f"ring{pr}x{pc}", JD._matmul_ring_prog(
                    mesh, sr, pr, pc, size, size)(A, {
                        f: np.stack([b[i] for b in bl])
                        for i, f in enumerate(("rows", "cols", "vals"))}))
            # the tiled program: per-shard plans padded to uniform sizes, as
            # DistAssoc._matmul_bsr pads them
            plans = []
            for s in range(P):
                ok = A["rows"][s] != SENT
                plans.append(plan_matmul(A["rows"][s][ok], A["cols"][s][ok],
                                         br, bc, M, K, N, impl="bsr"))
            n_a = max(max(len(p.a_blocks) for p in plans), 1)
            n_c = max(max(len(p.c_blocks) for p in plans), 1)
            n_pairs = max(max(len(p.pair_a) for p in plans), 1)
            cap = A["rows"].shape[1]
            tof = np.full((P, cap), n_a, np.int32)
            lr, lc = np.zeros((P, cap), np.int32), np.zeros((P, cap), np.int32)
            pa, pb = (np.zeros((P, n_pairs), np.int32) for _ in range(2))
            pcc = np.full((P, n_pairs), n_c, np.int32)
            cblk = np.full((P, n_c, 2), 1 << 20, np.int32)
            for s, p in enumerate(plans):
                ne, npr, ncb = len(p.a_tile_of), len(p.pair_a), len(p.c_blocks)
                tof[s, :ne], lr[s, :ne] = p.a_tile_of, p.a_lr
                lc[s, :ne] = p.a_lc
                pa[s, :npr], pb[s, :npr], pcc[s, :npr] = (p.pair_a, p.pair_b,
                                                          p.pair_c)
                cblk[s, :ncb] = p.c_blocks
            b_tiles = pack_tiles(jnp.asarray(bv), plans[0].b_tile_of,
                                 plans[0].b_lr, plans[0].b_lc,
                                 len(plans[0].b_blocks), TILE, TILE, sr.zero)
            put("bsr", JD._matmul_bsr_prog(mesh, sr, n_a, n_c, M, N, size,
                                           "auto")(
                A["vals"], tof, lr, lc, b_tiles, pa, pb, pcc, cblk))
"""

# the port's per-rank programs on the same staged inputs: rank ``mesh.rank``
# of ``P`` writes its outputs under the same names
_PORT_PROGRAMS = """
import torch
from repro_torch.core import dist_assoc as TD
from repro_torch.core.semiring import get_semiring as port_semiring
from repro_torch.core.spgemm import pack_b_tiles, plan_matmul


def port_programs(mesh, P, out):
    s = mesh.rank
    t = torch.from_numpy
    for nan in (False, True):
        st = stage(P, nan)
        A, (br, bc, bv), size = st["A"], st["B"], st["size"]
        a = tuple(t(np.ascontiguousarray(A[f][s]))
                  for f in ("rows", "cols", "vals"))
        flat = tuple(t(A[f].reshape(-1)) for f in ("rows", "cols", "vals"))
        b = (t(br), t(bc), t(bv))
        blk = tuple(t(x) for x in blocks(st, P, P, s))
        bm = torch.arange(K, dtype=torch.int32)
        srs = ("max_plus",) if nan else PROG_SEMIRINGS
        for name in srs:
            sr = port_semiring(name)
            tag = ("nan_" if nan else "") + "%s_" + name
            def put(key, o):
                if isinstance(o, dict):
                    for f, x in o.items():
                        out[tag % key + "__" + f] = x.numpy()
                else:
                    out[tag % key + "__vec"] = o.numpy()
            for axis in (0, 1):
                n_out = M if axis == 1 else N
                put(f"mr{axis}", TD._matmul_reduce_prog(
                    mesh, sr, size, n_out, axis, *a, *b))
                put(f"ra{axis}", TD._matmul_reduce_a2a_prog(
                    mesh, sr, size, n_out, axis, *flat, *blk, bm))
            if nan:
                continue
            put("mm", TD._matmul_prog(sr, size, size, *a, *b))
            put("a2a", TD._matmul_a2a_prog(
                mesh, sr, size, size, size, *flat, *blk, bm,
                t(st["bounds"])))
            for pr, pc in grids(P):
                put(f"ring{pr}x{pc}", TD._matmul_ring_prog(
                    mesh, sr, pr, pc, size, size, *a,
                    *(t(x) for x in blocks(st, P, pc, s))))
            ok = A["rows"][s] != SENT
            plan = plan_matmul(A["rows"][s][ok].astype(np.int64),
                               A["cols"][s][ok].astype(np.int64),
                               br.astype(np.int64), bc.astype(np.int64),
                               M, K, N, impl="bsr")
            put("bsr", TD._matmul_bsr_prog(sr, plan, t(A["vals"][s][ok]),
                                           pack_b_tiles(plan, b[2], sr),
                                           size, "auto"))
"""


def _prog_vec(name):
    return name.split("_")[0] in ("mr0", "mr1", "ra0", "ra1") or \
        name.startswith("nan_")


def _assert_shard_equal(got: dict, want: dict, name: str, s: int):
    """Port rank output ``got`` against JAX shard ``s`` of ``want``: the
    reduce vector, or the valid triples, nnz and true nnz."""
    if _prog_vec(name):
        np.testing.assert_array_equal(got[f"{name}__vec"],
                                      want[f"{name}__vec"])
        return
    for f in ("nnz", "true_nnz"):
        assert int(got[f"{name}__{f}"]) == int(
            np.asarray(want[f"{name}__{f}"]).reshape(-1)[s]), f
    jr = np.asarray(want[f"{name}__rows"])[s]
    ok = jr != SENT
    gr = got[f"{name}__rows"]
    gok = gr != SENT
    np.testing.assert_array_equal(gr[gok], jr[ok])
    np.testing.assert_array_equal(got[f"{name}__cols"][gok],
                                  np.asarray(want[f"{name}__cols"])[s][ok])
    np.testing.assert_array_equal(got[f"{name}__vals"][gok],
                                  np.asarray(want[f"{name}__vals"])[s][ok])


def _ns():
    ns = {}
    exec(_STAGE + _JAX_PROGRAMS + _PORT_PROGRAMS, ns)
    return ns


@pytest.fixture(scope="module")
def one_shard_programs():
    """Every program at one shard: the JAX ones in this process on a
    1-device mesh, the port's on this process's one-rank gloo mesh."""
    ns = _ns()
    jx, port = {}, {}
    ns["jax_programs"](jax.make_mesh((1,), ("data",)), 1, jx)
    ns["port_programs"](cpu_mesh(), 1, port)
    return jx, port


@pytest.mark.parametrize("name", _ns()["program_names"](1))
def test_one_shard_programs_equal_jax(one_shard_programs, name):
    jx, port = one_shard_programs
    _assert_shard_equal(port, jx, name, 0)


# ---------------------------------------------------------------------------
# end to end: the suite every rank runs (the ragged shapes of
# tests/test_dist_spgemm.py's 8-shard program), at four ranks and at one
# ---------------------------------------------------------------------------

_SUITE = """
import warnings
import numpy as np
import torch
import repro_torch.core as T
from repro_torch.core import (Assoc, AssocTensor, DistAssoc, PLAN_STATS,
                              REGISTRY)
from repro_torch.core.collectives import COLLECTIVE_STATS, PROLOGUE_STATS
from repro_torch.core.select import Range

IMPLS = ("auto_dist", "replicate", "all_to_all", "2d", "coo", "bsr")
STRATEGIES = ("replicate", "all_to_all", "2d")


def suite_data():
    rng = np.random.default_rng(7)
    d = {}
    d["ar"] = rng.integers(0, 37, 140).astype(str)
    d["ac"] = rng.integers(0, 29, 140).astype(str)
    d["av"] = rng.uniform(0.5, 3.0, 140)
    d["br"] = rng.integers(0, 29, 170).astype(str)
    d["bc"] = rng.integers(0, 23, 170).astype(str)
    d["bv"] = rng.uniform(0.5, 3.0, 170)
    # three row keys: the first of four shards is empty
    d["er"] = np.array([str(i % 3 + 1) for i in range(24)])
    d["ec"] = rng.integers(0, 29, 24).astype(str)
    d["ev"] = rng.uniform(0.5, 3.0, 24)
    # a small A against a large B whose contraction keys A mostly misses:
    # the cost model shards B
    d["lar"] = rng.integers(0, 16, 32).astype(str)
    d["lac"] = rng.integers(0, 29, 32).astype(str)
    d["lav"] = rng.integers(1, 5, 32).astype(np.float64)
    d["lbr"] = rng.integers(0, 1000, 20000).astype(str)
    d["lbc"] = rng.integers(0, 50, 20000).astype(str)
    d["lbv"] = rng.integers(1, 5, 20000).astype(np.float64)
    # a hub: every shard's expand above 4096 (the output estimate runs)
    d["har"] = rng.integers(0, 8, 200).astype(str)
    d["hac"] = rng.integers(0, 4, 200).astype(str)
    d["hav"] = rng.integers(1, 5, 200).astype(np.float64)
    d["hbr"] = rng.integers(0, 4, 6000).astype(str)
    d["hbc"] = rng.integers(0, 2000, 6000).astype(str)
    d["hbv"] = rng.integers(1, 5, 6000).astype(np.float64)
    return d


def suite(mesh, device, out):
    d = suite_data()
    dist = lambda r, c, v: DistAssoc.from_triples(
        r, c, v, mesh, aggregate="sum", device=device)
    da, db = dist(d["ar"], d["ac"], d["av"]), dist(d["br"], d["bc"], d["bv"])
    bt = AssocTensor.from_triples(d["br"], d["bc"], d["bv"], aggregate="sum",
                                  capacity=256, device=device)
    hb = Assoc(d["br"], d["bc"], d["bv"], aggregate="sum")

    def counted(name, fn):
        T.reset_collective_stats()
        before = {k: PLAN_STATS["dist_" + k] for k in STRATEGIES}
        res = fn()
        out[name + "__prog"] = np.asarray([COLLECTIVE_STATS[k] for k in (
            "all_reduce", "all_gather", "all_to_all", "ring_shift")])
        out[name + "__prologue"] = np.asarray(
            [PROLOGUE_STATS[k] for k in ("all_reduce", "all_gather")])
        ran = [k for k in STRATEGIES if PLAN_STATS["dist_" + k] > before[k]]
        out[name + "__strategy"] = np.asarray(ran[0] if ran else "")
        return res

    def put(name, res):
        if isinstance(res, DistAssoc):
            loc = res.local
            n = int(loc.nnz)
            out[name + "__r"] = loc.row_space.keys[loc.rows[:n].numpy()]
            out[name + "__c"] = loc.col_space.keys[loc.cols[:n].numpy()]
            out[name + "__v"] = loc.vals[:n].double().numpy()
            out[name + "__overflow"] = np.asarray(bool(res.overflow))
        elif isinstance(res, AssocTensor):
            n = int(res.nnz)
            out[name + "__tr"] = res.row_space.keys[res.rows[:n].numpy()]
            out[name + "__tc"] = res.col_space.keys[res.cols[:n].numpy()]
            out[name + "__tv"] = res.vals[:n].double().numpy()
        else:
            out[name + "__vec"] = res.double().numpy()

    def setup(name, a, b):
        st = a._matmul_setup(b)
        for f in ("a_rows_h", "a_cols_h", "counts", "b_rows_h"):
            out[name + "__" + f] = getattr(st, f)
        out[name + "__k"] = np.asarray(len(st.ks))
        if st.a2a_bounds is not None:
            out[name + "__a2a_bounds"] = st.a2a_bounds

    for tag, B in (("resident", db), ("staged", bt), ("host", hb)):
        setup("setup_" + tag, da, B)
        for impl in IMPLS:
            name = "mm_%s_%s" % (impl, tag)
            put(name, counted(name, lambda: da.matmul(B, impl=impl)))
    for g in [(mesh.size // pc, pc) for pc in range(1, mesh.size + 1)
              if mesh.size % pc == 0]:
        name = "grid%dx%d" % g
        put(name, counted(name, lambda: da.matmul(db, impl="2d", grid=g)))
    for sr in sorted(REGISTRY):
        for impl in STRATEGIES:
            put("sr_%s_%s" % (sr, impl), da.matmul(db, sr, impl=impl))
    for axis in (0, 1):
        for impl in ("replicate", "all_to_all", "auto_dist"):
            for tag, B in (("staged", bt), ("resident", db)):
                name = "mr%d_%s_%s" % (axis, impl, tag)
                put(name, counted(name, lambda: da.matmul_reduce(
                    B, axis=axis, impl=impl)))
    de = dist(d["er"], d["ec"], d["ev"])
    out["empty__nnz"] = np.asarray(int(de.local.nnz))
    for impl in ("auto_dist", "replicate", "all_to_all", "2d"):
        put("empty_" + impl, de.matmul(bt, impl=impl))
    for red in (None, 0, 1):
        name = "sqout_%s" % red
        put(name, counted(name, lambda: da.sqout(reduce=red)))
        name = "sqin_%s" % red
        put(name, counted(name, lambda: da.sqin(reduce=red)))
    put("op_matmul", counted("op_matmul", lambda: da @ db))
    put("op_matmul_host", da @ hb)
    keys = np.unique(d["ar"])
    sel = Range(keys[5], keys[20])
    T.reset_plan_stats()
    put("lazy_sel", (da.lazy()[sel, :] @ db.lazy()).collect())
    put("lazy_sel_sum", (da.lazy()[sel, :] @ db.lazy()).sum(axis=1).collect())
    put("lazy_bsel", (da.lazy() @ db.lazy()[sel, :]).collect())
    out["lazy__fused"] = np.asarray(PLAN_STATS["fused_select_matmul"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        put("overflow", counted("overflow", lambda: da.matmul(
            db, impl="coo", out_capacity_per_shard=8)))
    out["overflow__warned"] = np.asarray(any(
        issubclass(w.category, RuntimeWarning)
        and "out_capacity_per_shard" in str(w.message) for w in caught))
    for bad in (dict(impl="telepathy"), dict(kernel_impl="triton")):
        try:
            da.matmul(db, **bad)
            out["bad_%s__raised" % list(bad)[0]] = np.asarray(False)
        except ValueError:
            out["bad_%s__raised" % list(bad)[0]] = np.asarray(True)
    # the large-B and hub cases
    la = dist(d["lar"], d["lac"], d["lav"])
    lb = AssocTensor.from_triples(d["lbr"], d["lbc"], d["lbv"],
                                  aggregate="sum", device=device)
    setup("setup_large", la, lb)
    put("large", counted("large", lambda: la.matmul(lb)))
    ha = dist(d["har"], d["hac"], d["hav"])
    hbt = AssocTensor.from_triples(d["hbr"], d["hbc"], d["hbv"],
                                   aggregate="sum", device=device)
    setup("setup_hub", ha, hbt)
    put("hub", counted("hub", lambda: ha.matmul(hbt, impl="replicate")))
"""

_FOUR_JAX = _STAGE + _JAX_PROGRAMS + """
import sys
import jax
assert jax.device_count() == 4
out = {}
jax_programs(jax.make_mesh((4,), ("data",)), 4, out)
np.savez(sys.argv[1], **out)
"""

_FOUR_PORT = _STAGE + _PORT_PROGRAMS + _SUITE + """
out = {}
port_programs(mesh, WORLD, out)
suite(mesh, "cpu", out)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _four_started(tmp_path_factory):
    """The JAX process and the four port ranks, started before the module's
    first test and stopped after its last."""
    run = SpmdRun(_FOUR_JAX, _FOUR_PORT, tmp_path_factory.mktemp("dmm4"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def four(_four_started):
    return _four_started.result()


@pytest.mark.parametrize("name", _ns()["program_names"](4))
def test_four_shard_programs_equal_jax(four, name):
    jx, ranks = four
    for s, got in enumerate(ranks):
        _assert_shard_equal(got, jx, name, s)


def _suite_ns():
    ns = {}
    exec(_SUITE, ns)
    return ns


@pytest.fixture(scope="module")
def one_rank():
    """The suite at one rank, in this process."""
    ns, out = _suite_ns(), {}
    ns["suite"](cpu_mesh(), "cpu", out)
    return [out]


@pytest.fixture(scope="module")
def host():
    """The host ``Assoc`` operands of the suite (the JAX package's)."""
    from repro.core import Assoc
    d = _suite_ns()["suite_data"]()
    h = {k: Assoc(d[k + "r"], d[k + "c"], d[k + "v"], aggregate="sum")
         for k in ("a", "b", "e", "la", "lb", "ha", "hb")}
    return d, h


def _key_triples(x):
    coo = x.adj.tocoo()
    order = np.lexsort((coo.col, coo.row))
    return (x.row[coo.row[order]], x.col[coo.col[order]],
            coo.data[order].astype(np.float64))


def _assert_dist_equals(ranks, name, want):
    """The ranks' shards of ``name``, in rank order, against the host
    array's triples (shards are row ranges in order, so the concatenation
    is the canonical order)."""
    got = [np.concatenate([r[f"{name}__{f}"] for r in ranks])
           for f in ("r", "c", "v")]
    w = _key_triples(want)
    np.testing.assert_array_equal(got[0], w[0])
    np.testing.assert_array_equal(got[1], w[1])
    np.testing.assert_allclose(got[2], w[2], rtol=RTOL, atol=ATOL)


SUITE_IMPLS = ("auto_dist", "replicate", "all_to_all", "2d", "coo", "bsr")
B_KINDS = ("resident", "staged", "host")


@pytest.fixture(params=["one_rank", "four"], ids=["1rank", "4ranks"])
def ranks(request):
    if request.param == "four":
        return request.getfixturevalue("four")[1]
    return request.getfixturevalue("one_rank")


@pytest.mark.parametrize("impl", SUITE_IMPLS)
@pytest.mark.parametrize("kind", B_KINDS)
def test_matmul_every_impl_equals_host(ranks, host, impl, kind):
    _, h = host
    _assert_dist_equals(ranks, f"mm_{impl}_{kind}", h["a"] @ h["b"])


def test_matmul_every_grid_equals_host(ranks, host):
    _, h = host
    P = len(ranks)
    grids = [(P // pc, pc) for pc in range(1, P + 1) if P % pc == 0]
    for g in grids:
        _assert_dist_equals(ranks, "grid%dx%d" % g, h["a"] @ h["b"])
        # the ring program shifts pc - 1 times
        for r in ranks:
            assert r["grid%dx%d__prog" % g][3] == g[1] - 1


@pytest.mark.parametrize("sr", sorted(T.REGISTRY))
@pytest.mark.parametrize("impl", ["replicate", "all_to_all", "2d"])
def test_matmul_registry_equals_host(ranks, host, sr, impl):
    from repro.core import REGISTRY
    _, h = host
    _assert_dist_equals(ranks, f"sr_{sr}_{impl}",
                        h["a"].matmul(h["b"], REGISTRY[sr]))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("impl", ["replicate", "all_to_all", "auto_dist"])
@pytest.mark.parametrize("kind", ["staged", "resident"])
def test_matmul_reduce_equals_host(ranks, host, axis, impl, kind):
    d, h = host
    prod = h["a"] @ h["b"]
    keys = (np.unique(d["ar"]) if axis == 1 else np.unique(d["bc"]))
    want = np.zeros(len(keys))
    vec = np.asarray(prod.adj.sum(axis=axis)).ravel()
    want[np.searchsorted(keys, prod.row if axis == 1 else prod.col)] = vec
    for r in ranks:
        np.testing.assert_allclose(r[f"mr{axis}_{impl}_{kind}__vec"], want,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto_dist", "replicate", "all_to_all",
                                  "2d"])
def test_empty_shard_equals_host(ranks, host, impl):
    _, h = host
    if len(ranks) == 4:
        assert int(ranks[0]["empty__nnz"]) == 0
    _assert_dist_equals(ranks, f"empty_{impl}", h["e"] @ h["b"])


@pytest.mark.parametrize("red", [None, 0, 1])
def test_sqout_sqin_equal_host(ranks, host, red):
    d, h = host
    a = h["a"]
    if red is None:
        _assert_dist_equals(ranks, "sqout_None", a.sqout())
        want = _key_triples(a.sqin())
        for r in ranks:   # sqin: a replicated AssocTensor on every rank
            np.testing.assert_array_equal(r["sqin_None__tr"], want[0])
            np.testing.assert_array_equal(r["sqin_None__tc"], want[1])
            np.testing.assert_allclose(r["sqin_None__tv"], want[2],
                                       rtol=RTOL, atol=ATOL)
        return
    rk, ck = np.unique(d["ar"]), np.unique(d["ac"])
    for name, prod, keys in (("sqout", a.sqout(), rk), ("sqin", a.sqin(), ck)):
        want = np.zeros(len(keys))
        want[np.searchsorted(keys, prod.row if red == 1 else prod.col)] = \
            np.asarray(prod.adj.sum(axis=red)).ravel()
        for r in ranks:
            np.testing.assert_allclose(r[f"{name}_{red}__vec"], want,
                                       rtol=RTOL, atol=ATOL)


def test_operator_lazy_overflow_and_errors(ranks, host):
    from repro.core import Range
    d, h = host
    want = h["a"] @ h["b"]
    _assert_dist_equals(ranks, "op_matmul", want)
    _assert_dist_equals(ranks, "op_matmul_host", want)
    keys = np.unique(d["ar"])
    sel = Range(keys[5], keys[20])
    _assert_dist_equals(ranks, "lazy_sel", h["a"][sel, :] @ h["b"])
    _assert_dist_equals(ranks, "lazy_bsel", h["a"] @ h["b"][sel, :])
    part = h["a"][sel, :] @ h["b"]
    want_vec = np.zeros(len(keys))
    want_vec[np.searchsorted(keys, part.row)] = \
        np.asarray(part.adj.sum(axis=1)).ravel()
    for r in ranks:
        np.testing.assert_allclose(r["lazy_sel_sum__vec"], want_vec,
                                   rtol=RTOL, atol=ATOL)
        assert int(r["lazy__fused"]) == 3
        assert bool(r["bad_impl__raised"])
        assert bool(r["bad_kernel_impl__raised"])
    # the flag is global, as the reference's: True on every rank when any
    # shard's product outgrows 8 entries; only that shard's rank warns.
    # One prologue all_reduce MAX ORs it at four ranks, none at one
    mine = [len(r["mm_coo_resident__r"]) > 8 for r in ranks]
    assert any(mine)
    for r, o in zip(ranks, mine):
        assert bool(r["overflow__overflow"]) is True
        assert bool(r["overflow__warned"]) == o
        assert len(r["overflow__r"]) <= 8
    _assert_counts(ranks, "overflow", _expected(ranks, "overflow",
                                                resident=True))


def test_large_b_and_hub_equal_host(ranks, host):
    _, h = host
    _assert_dist_equals(ranks, "large", h["la"] @ h["lb"])
    _assert_dist_equals(ranks, "hub", h["ha"] @ h["hb"])


def _jax_plan(ranks, case, **kw):
    """JAX's plan_dist_matmul on the ranks' stacked setup arrays (the
    global inputs the single controller would have read)."""
    st = {f: np.stack([r[f"setup_{case}__{f}"] for r in ranks])
          for f in ("a_rows_h", "a_cols_h", "counts")}
    b_rows = ranks[0][f"setup_{case}__b_rows_h"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"setup_{case}__b_rows_h"], b_rows)
    a2a = ranks[0].get(f"setup_{case}__a2a_bounds")
    return JS.plan_dist_matmul(st["a_rows_h"], st["a_cols_h"], st["counts"],
                               b_rows, int(ranks[0][f"setup_{case}__k"]),
                               len(ranks), b_resident=a2a is not None,
                               a2a_bounds=a2a, **kw)


@pytest.mark.parametrize("case", ["resident", "staged", "host", "large"])
def test_auto_dist_picks_the_jax_strategy(ranks, case):
    want = _jax_plan(ranks, case).strategy
    name = "large" if case == "large" else f"mm_auto_dist_{case}"
    for r in ranks:
        assert str(r[f"{name}__strategy"]) == want
    if case == "large" and len(ranks) == 4:
        assert want in ("all_to_all", "2d")


def _contract(fn) -> int:
    return getattr(fn, CONTRACT_ATTR).collectives


def _expected(ranks, name, *, resident, reduce=False, case=None):
    """(program, prologue) counts of one product ``name`` run with the
    strategy it recorded: program ``[all_reduce, all_gather, all_to_all,
    ring_shift]`` from the JAX ``@contract`` (the ring's: pc − 1 of the
    grid run), prologue ``[all_reduce, all_gather]`` from the table of
    ``repro_torch.core.dist_assoc``'s docstring (none at one rank);
    ``case`` names the setup arrays that give the JAX plan (its grid and
    replicate expand)."""
    P = len(ranks)
    strategy = str(ranks[0][f"{name}__strategy"])
    prog = [0, 0, 0, 0]
    if reduce:
        prog[0] = _contract(JD.DistAssoc.matmul_reduce if strategy ==
                            "replicate" else JD._matmul_reduce_a2a_prog)
    elif strategy == "all_to_all":
        prog[2] = _contract(JD._matmul_a2a_prog)
    elif strategy == "2d":
        # the contract's probe grid is 2x4: pc − 1 shifts
        assert _contract(JD._matmul_ring_prog) == 4 - 1
        prog[3] = _jax_plan(ranks, case).grid[1] - 1
    else:
        assert _contract(JD.DistAssoc.matmul) == 0
        assert _contract(JD._matmul_bsr_prog) == 0
    if P == 1:
        return prog, [0, 0]
    gathers = 1 + int(resident) + int(strategy == "all_to_all")
    cap_max = int(not reduce and case is not None and _jax_plan(
        ranks, case).expands["replicate"] > 4096)
    # a product (not a fused reduce) ORs its overflow flag: one MAX
    return prog, [cap_max + int(not reduce), gathers]


def _assert_counts(ranks, name, want):
    prog, pro = want
    for r in ranks:
        assert r[f"{name}__prog"].tolist() == prog, name
        assert r[f"{name}__prologue"].tolist() == pro, name


@pytest.mark.parametrize("impl", SUITE_IMPLS)
@pytest.mark.parametrize("kind", B_KINDS)
def test_matmul_collectives(ranks, impl, kind):
    name = f"mm_{impl}_{kind}"
    strategy = str(ranks[0][f"{name}__strategy"])
    assert strategy == {"auto_dist": _jax_plan(ranks, kind).strategy,
                        "coo": "replicate", "bsr": "replicate"}.get(impl, impl)
    _assert_counts(ranks, name, _expected(ranks, name, case=kind,
                                          resident=kind == "resident"))


def test_reduce_sq_and_hub_collectives(ranks):
    for axis in (0, 1):
        for impl in ("replicate", "all_to_all", "auto_dist"):
            for kind in ("staged", "resident"):
                name = f"mr{axis}_{impl}_{kind}"
                _assert_counts(ranks, name, _expected(
                    ranks, name, resident=kind == "resident", reduce=True))
    _assert_counts(ranks, "op_matmul", _expected(
        ranks, "op_matmul", resident=True, case="resident"))
    _assert_counts(ranks, "hub", _expected(ranks, "hub", resident=False,
                                           case="hub"))
    assert _jax_plan(ranks, "hub").expands["replicate"] > 4096
    # sqout: Aᵀ gathered (gather_replicated's all_gather, counted apart
    # from the product), then the dist product (sqout(reduce=): the fused
    # reduce's one all_reduce, the JAX contract); sqin's product runs on
    # the replicated array, so only the gather
    for red in (None, 0, 1):
        prog, pro = _expected(ranks, f"sqout_{red}", resident=False,
                              reduce=red is not None)
        prog[1] += 1
        _assert_counts(ranks, f"sqout_{red}", (prog, pro))
        _assert_counts(ranks, f"sqin_{red}", ([0, 1, 0, 0], [0, 0]))
    assert _contract(JD.DistAssoc.sqout) == 1


# ---------------------------------------------------------------------------
# NaN in the dist combine, and devices
# ---------------------------------------------------------------------------

def test_four_rank_nan_reduce_follows_the_reference(four):
    """``matmul_reduce`` under MAX_PLUS with NaN in A's shards 0 and 2: the
    JAX programs at four shards drop a NaN partial (pmax), and so do the
    port's ranks; the one-shard programs keep it (the in-process test
    above)."""
    jx, ranks = four
    for name in ("nan_mr0_max_plus", "nan_mr1_max_plus", "nan_ra1_max_plus"):
        assert not np.isnan(jx[f"{name}__vec"]).any()
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}__vec"],
                                          jx[f"{name}__vec"])


def test_one_shard_nan_reduce_keeps_nan(one_shard_programs):
    jx, port = one_shard_programs
    for name in ("nan_mr0_max_plus", "nan_mr1_max_plus"):
        assert np.isnan(jx[f"{name}__vec"]).any()
        np.testing.assert_array_equal(port[f"{name}__vec"],
                                      jx[f"{name}__vec"])


def test_cpu_mesh_refuses_an_operand_off_its_device():
    mesh = cpu_mesh()
    a = T.DistAssoc.from_triples(["a", "b"], ["x", "y"], [1.0, 2.0], mesh,
                                 device="cpu")
    b = T.AssocTensor.from_triples(["x", "y"], ["u", "v"], [1.0, 2.0],
                                   device="cpu")
    off = T.AssocTensor(b.rows.to("meta"), b.cols.to("meta"),
                        b.vals.to("meta"), b.nnz.to("meta"), b.row_space,
                        b.col_space)
    for call in (lambda: a.matmul(off), lambda: a.matmul_reduce(off),
                 lambda: a @ off):
        with pytest.raises(ValueError, match="meta"):
            call()
    for bad in ("triton", "pallas", "interpret"):
        with pytest.raises(ValueError, match="kernel_impl"):
            a.matmul(b, kernel_impl=bad)
    with pytest.raises(ValueError, match="impl"):
        a.matmul_reduce(b, impl="2d")
    with pytest.raises(ValueError, match="does not tile"):
        a.matmul(b, impl="2d", grid=(2, 1))
    assert T.PLAN_STATS["dist_replicate"] == 0


def test_one_rank_plan_stats_and_kernel_impls():
    """At one rank ``auto_dist`` replicates; every impl is counted in
    PLAN_STATS; ``kernel_impl="ref"`` and ``"auto"`` give the same tiled
    product on the CPU."""
    d = _suite_ns()["suite_data"]()
    mesh = cpu_mesh()
    a = T.DistAssoc.from_triples(d["ar"], d["ac"], d["av"], mesh,
                                 aggregate="sum", device="cpu")
    b = T.AssocTensor.from_triples(d["br"], d["bc"], d["bv"],
                                   aggregate="sum", device="cpu")
    for impl in SUITE_IMPLS:
        a.matmul(b, impl=impl)
    assert T.PLAN_STATS["dist_replicate"] == 4
    assert T.PLAN_STATS["dist_all_to_all"] == T.PLAN_STATS["dist_2d"] == 1
    x = a.matmul(b, impl="bsr", kernel_impl="ref")
    y = a.matmul(b, impl="bsr", kernel_impl="auto")
    for f in ("rows", "cols", "vals", "nnz"):
        assert torch.equal(getattr(x.local, f), getattr(y.local, f))
    assert COLLECTIVE_STATS["all_to_all"] == 1
    assert PROLOGUE_STATS == {"all_reduce": 0, "all_gather": 0}


def test_dist_product_main_path_small():
    """The dist-product slice of the main path at clustered n=10 and uniform
    n=8 on one rank: every result equals the host ``Assoc`` and the device
    result, entry by entry, with the collectives of
    ``main_path.DIST_PRODUCT_COLLECTIVES`` and all three strategies run."""
    from repro_torch import main_path
    mesh = cpu_mesh()
    clus = main_path.build_clustered(10, "cpu")
    res = main_path.drive_clustered(clus["A"], clus["B"])
    uni = main_path.build_uniform(8, "cpu")
    res_u = main_path.drive_uniform(uni["A"], uni["B"])
    dc = main_path.build_dist(clus["raw"], mesh, "cpu")
    du = main_path.build_dist(uni["raw"], mesh, "cpu")
    T.reset_all_stats()
    drv = main_path.drive_dist_product(dc, du, res["selector"])
    checks = main_path.check_dist_product(clus["raw"], uni["raw"], drv, res,
                                          res_u, clus["A"].row_space.keys,
                                          full=True)
    assert len(checks) == 39
    assert all(ok for _, ok, _ in checks), [c for c in checks if not c[1]]
    assert set(drv["stages_ms"]) >= {"setup", "dist_plan", "kernel"}
    assert drv["plan"]["strategy"] == "replicate"
