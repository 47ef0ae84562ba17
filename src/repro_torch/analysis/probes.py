"""Contract probes: the programs behind each decorated entry point, ready to
run.

A probe is registered under a contract's name and called with a
:class:`ProbeContext` (the device and the mesh it runs on).  It yields, per
program behind the entry point, a ``(label, thunk)`` pair — a
``functools.partial`` of the port program over seeded inputs, which the
checker runs once, counted (:func:`~repro_torch.analysis.report.trace_call`)
— plus :class:`~repro_torch.analysis.contracts.RetraceAudit` items for the
host caches of the port and :class:`~repro_torch.analysis.contracts.NotRun`
items for a program this mesh cannot run.

The labels, programs, strategies, axes and semiring (``plus_times``) are
those of the JAX package's ``repro.analysis.probes``, and so is the
geometry: COO capacities of 64 triples (a tensor, or one rank's shard)
over 4096 key ranks per axis, so a program that builds anything
``O(nr·nc)`` jumps ~100× above the ``8 × max_input`` budget.  What the JAX
probes lower, the port runs: the planner side (selector compilation, the
product prologue, tile plans) runs eagerly before the thunk, as it runs
outside the compiled program in the JAX package, and the thunk is the
program.  The JAX package's shapes are global over 8 shards; a port
program runs on one rank's shard, so its inputs are that shard's.

The JAX retrace audits watch ``jax.jit`` / ``lru_cache`` program
factories.  The port traces nothing, so where a host cache of the port
plays that part it is audited instead (the selector compile cache for the
selection probes, the plan cache for ``serve.execute``); where none does,
the probe says so.

The (+, ×) tile inputs are multiples of 1/4 in [1/4, 2], so every product
and sum of the pair-list programs is exact in fp32 on both routes of the
card; all values are positive.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from .contracts import NotRun, RetraceAudit

__all__ = ["PROBES", "ProbeContext", "context", "probe_for"]

#: contract name -> probe
PROBES: Dict[str, Callable[["ProbeContext"], Iterable]] = {}

# probe geometry: nnz capacity per (rank shard|tensor) and keyspace extent
_CAP = 64
_NKEYS = 4096
_TILE = 128
# the JAX probe's 2-D grid is 2 x 4 over 8 shards: pc - 1 = 3 ring shifts
_RING_PC = 4
_SEED = 0


@dataclasses.dataclass(frozen=True)
class ProbeContext:
    """Where the probes run: the device of their inputs and the mesh of the
    dist programs (this process's rank of it)."""
    device: torch.device
    mesh: object


@functools.lru_cache(maxsize=None)
def _default_mesh(device: str):
    from repro_torch.core.mesh import make_mesh
    return make_mesh(device)


def context(device="cuda", mesh=None) -> ProbeContext:
    """The probes' context on ``device`` (``"cuda"`` raises without a card)
    and ``mesh`` (default: one one-rank mesh per device and process)."""
    from repro_torch.core.assoc_tensor import resolve_device

    dev = resolve_device(device)
    if mesh is None:
        mesh = _default_mesh(str(dev))
    elif mesh.device.type != dev.type:
        raise ValueError(f"mesh on {mesh.device} for probes on {dev}")
    return ProbeContext(mesh.device, mesh)


def probe_for(name: str):
    def deco(fn):
        PROBES[name] = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# Shared inputs (seeded, built per probe on the context's device)
# --------------------------------------------------------------------------

def _keys() -> np.ndarray:
    return np.array([f"k{i:04d}" for i in range(_NKEYS)])


def _space():
    from repro_torch.core.keyspace import KeySpace
    return KeySpace(_keys())


def _device_tensor(ctx: ProbeContext):
    """64 stored triples over 4096 × 4096 key ranks, as the JAX probe's."""
    from repro_torch.core.assoc_tensor import AssocTensor

    keys, space = _keys(), _space()
    idx = np.arange(_CAP) * (_NKEYS // _CAP)
    return AssocTensor.from_triples(
        keys[idx], keys[(idx * 7) % _NKEYS],
        np.arange(_CAP, dtype=np.float32) + 1.0, capacity=_CAP,
        row_space=space, col_space=space, device=ctx.device)


def _dist(ctx: ProbeContext):
    """64 triples a rank over 4096 × 4096 key ranks, row-sharded over the
    mesh (every rank builds it from the same triples)."""
    from repro_torch.core.dist_assoc import DistAssoc

    keys, space = _keys(), _space()
    n = _CAP * ctx.mesh.size
    idx = np.arange(n) * (_NKEYS // n)
    return DistAssoc.from_triples(
        keys[idx], keys[(idx * 7) % _NKEYS],
        (np.arange(n) % 8 + 1).astype(np.float32) / 4, ctx.mesh,
        capacity_per_shard=_CAP, row_space=space, col_space=space,
        device=ctx.device)


def _quarters(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randint(1, 9, shape, generator=gen).float() / 4


def _raw_delta(ctx: ProbeContext, rows_lo: int = 0, rows_hi: int = _NKEYS):
    """A raw delta buffer: 64 seeded triples, unsorted, with duplicates."""
    rng = np.random.default_rng(_SEED)
    r = rng.integers(rows_lo, rows_hi, _CAP).astype(np.int32)
    c = rng.integers(0, _NKEYS, _CAP).astype(np.int32)
    r[1::4], c[1::4] = r[::4], c[::4]                 # duplicates
    v = (rng.integers(1, 9, _CAP) / 4).astype(np.float32)
    return tuple(torch.from_numpy(x).to(ctx.device) for x in (r, c, v))


def _selector_kinds():
    """One selector pair per device dispatch kind (range/multirange/
    hybrid/gather), matching ``select.plan_boxes``'s four paths."""
    from repro_torch.core.select import All, Keys, Range

    keys = _keys()
    scattered = list(keys[::5][:40])       # >4 interval runs -> gather
    tworuns = list(keys[10:20]) + list(keys[100:110])   # 2 runs -> boxes
    return [
        ("range", (Range(keys[4], keys[2000]), All())),
        ("multirange", (Keys(tworuns), All())),
        ("hybrid", (Range(keys[4], keys[2000]), Keys(scattered))),
        ("gather", (Keys(scattered), Keys(scattered))),
    ]


def _compile_audit(label: str, compile_again: Callable[[], object]):
    """The selector compile cache must not miss on a repeat selection."""
    from repro_torch.core.select import CACHE_STATS

    return RetraceAudit(label=label, first=compile_again, again=compile_again,
                        size=lambda: CACHE_STATS["misses"])


def _plus_times():
    from repro_torch.core.semiring import PLUS_TIMES, get_semiring
    return get_semiring(PLUS_TIMES)


# --------------------------------------------------------------------------
# AssocTensor (single device)
# --------------------------------------------------------------------------

def _assign(x, ij, value):
    """``__setitem__`` on a copy of ``x``: the new values (the entry point
    mutates its receiver)."""
    from repro_torch.core.assoc_tensor import AssocTensor

    c = AssocTensor(x.rows, x.cols, x.vals, x.nnz, x.row_space, x.col_space,
                    x.val_space)
    c[ij] = value
    return c.vals


@probe_for("AssocTensor.__getitem__")
def _probe_tensor_getitem(ctx):
    from repro_torch.core.assoc_tensor import AssocTensor

    t = _device_tensor(ctx)
    for label, sel in _selector_kinds():
        yield label, functools.partial(AssocTensor._select_eager, t, sel)
    yield _compile_audit("select-compile-cache",
                         lambda: t._compiled_pair(_selector_kinds()[0][1]))


@probe_for("AssocTensor.__setitem__")
def _probe_tensor_setitem(ctx):
    t = _device_tensor(ctx)
    for label, sel in _selector_kinds():
        yield label, functools.partial(_assign, t, sel, 0.0)
    yield _compile_audit("select-compile-cache",
                         lambda: t._compiled_pair(_selector_kinds()[3][1]))


# --------------------------------------------------------------------------
# spgemm kernel programs (single device; the host-driven planner around
# them is eager by design, so the contract lives in the kernel programs).
# The pair lists come from the host, as the planner gives them.
# --------------------------------------------------------------------------

def _pairlist_args(ctx, n_pairs: int = 16, n_a: int = 8, n_b: int = 8,
                   n_out: int = 4):
    gen = torch.Generator().manual_seed(_SEED)
    a = _quarters(gen, n_a, _TILE, _TILE).to(ctx.device)
    b = _quarters(gen, n_b, _TILE, _TILE).to(ctx.device)
    rng = np.random.default_rng(_SEED)
    pa = rng.integers(0, n_a, n_pairs).astype(np.int32)
    pb = rng.integers(0, n_b, n_pairs).astype(np.int32)
    px = (np.arange(n_pairs) * n_out // n_pairs).astype(np.int32)  # sorted
    return a, b, pa, pb, px


@probe_for("spgemm.matmul")
def _probe_spgemm_matmul(ctx):
    from repro_torch.kernels.bsr_spgemm import ops

    a, b, pa, pb, pc = _pairlist_args(ctx)
    yield "bsr_pairlist", functools.partial(
        ops.bsr_pairlist, a, b, pa, pb, pc, n_c=4, semiring="plus_times",
        impl="auto")
    # the JAX audit watches bsr_pairlist's jit cache: the port's wrapper
    # traces and caches nothing


@probe_for("spgemm.matmul_reduce")
def _probe_spgemm_matmul_reduce(ctx):
    from repro_torch.kernels.bsr_spgemm import ops

    a, b, pa, pb, po = _pairlist_args(ctx)
    for axis in (1, 0):
        yield f"bsr_pairlist_reduce-axis{axis}", functools.partial(
            ops.bsr_pairlist_reduce, a, b, pa, pb, po, n_o=4, axis=axis,
            semiring="plus_times", impl="auto")


# --------------------------------------------------------------------------
# DistAssoc: the shard programs of this rank, on the context's mesh
# --------------------------------------------------------------------------

def _dist_selections(ctx, labels):
    a = _dist(ctx)
    kinds = dict(_selector_kinds())
    for label in labels:
        yield label, a, a._compiled_selection(kinds[label])


@probe_for("DistAssoc.__getitem__")
def _probe_dist_getitem(ctx):
    from repro_torch.core.dist_assoc import _select_prog

    for label, a, compiled in _dist_selections(
            ctx, ("range", "multirange", "hybrid", "gather")):
        yield label, functools.partial(_select_prog, a.local, *compiled)
    yield _compile_audit(
        "select-compile-cache",
        lambda: a._compiled_selection(_selector_kinds()[0][1]))


@probe_for("DistAssoc.__setitem__")
def _probe_dist_setitem(ctx):
    from repro_torch.core.dist_assoc import _setvals_prog

    for label, a, compiled in _dist_selections(ctx, ("range", "gather")):
        yield label, functools.partial(_setvals_prog, a.local, *compiled,
                                       np.float32(0.0))
    yield _compile_audit(
        "select-compile-cache",
        lambda: a._compiled_selection(_selector_kinds()[3][1]))


@probe_for("DistAssoc.add")
def _probe_dist_add(ctx):
    from repro_torch.core.dist_assoc import _ewise_prog

    loc = _dist(ctx).local
    yield "ewise-add", functools.partial(_ewise_prog, loc, loc, _plus_times(),
                                         "add")


@probe_for("DistAssoc.mul")
def _probe_dist_mul(ctx):
    from repro_torch.core.dist_assoc import _ewise_prog

    loc = _dist(ctx).local
    yield "ewise-mul", functools.partial(_ewise_prog, loc, loc, _plus_times(),
                                         "mul")


def _product_setup(ctx):
    """A (this rank's shard) against the replicated B, through the
    product's prologue: ``(a, setup, (A triples), (B triples))`` with A's
    cols on the contraction space."""
    a = _dist(ctx)
    st = a._matmul_setup(_device_tensor(ctx))
    return (a, st, (st.a_loc.rows, st.a_cols, st.a_loc.vals.float()),
            (st.b_rows, st.b_cols, st.b_vals))


@probe_for("DistAssoc.matmul")
def _probe_dist_matmul(ctx):
    from repro_torch.core.dist_assoc import _matmul_prog

    _, _, a, b = _product_setup(ctx)
    yield "coo-expand-join", functools.partial(
        _matmul_prog, _plus_times(), 256, 256, *a, *b)
    # the JAX audit watches _matmul_prog's lru_cache: the port's program
    # is a plain function, built once


@probe_for("DistAssoc.matmul_reduce")
def _probe_dist_matmul_reduce(ctx):
    from repro_torch.core.dist_assoc import _matmul_reduce_prog

    _, _, a, b = _product_setup(ctx)
    for axis in (1, 0):
        yield f"axis{axis}", functools.partial(
            _matmul_reduce_prog, ctx.mesh, _plus_times(), 256, _NKEYS, axis,
            *a, *b)


def _probe_reduce_epilogue(ctx):
    # sqin/sqout's collective claim IS the fused matmul_reduce program
    # (reduce=None delegates to matmul, checked under its own contract)
    from repro_torch.core.dist_assoc import _matmul_reduce_prog

    _, _, a, b = _product_setup(ctx)
    yield "reduce-epilogue", functools.partial(
        _matmul_reduce_prog, ctx.mesh, _plus_times(), 256, _NKEYS, 1, *a, *b)


PROBES["DistAssoc.sqin"] = _probe_reduce_epilogue
PROBES["DistAssoc.sqout"] = _probe_reduce_epilogue


@probe_for("DistAssoc.col_reduce")
def _probe_dist_col_reduce(ctx):
    from repro_torch.core.dist_assoc import _col_reduce_prog

    loc = _dist(ctx).local
    yield "col-reduce", functools.partial(
        _col_reduce_prog, ctx.mesh, _plus_times(), _NKEYS, loc.cols, loc.vals,
        loc.rows)


@probe_for("DistAssoc.row_reduce")
def _probe_dist_row_reduce(ctx):
    # the column program keyed by the row ranks (the JAX label)
    from repro_torch.core.dist_assoc import _col_reduce_prog

    loc = _dist(ctx).local
    yield "col-reduce", functools.partial(
        _col_reduce_prog, ctx.mesh, _plus_times(), _NKEYS, loc.rows, loc.vals,
        loc.rows)


@probe_for("DistAssoc.col_degree")
def _probe_dist_col_degree(ctx):
    from repro_torch.core.dist_assoc import _col_degree_prog

    loc = _dist(ctx).local
    yield "col-degree", functools.partial(_col_degree_prog, ctx.mesh, _NKEYS,
                                          loc.cols, loc.rows)


@probe_for("DistAssoc.matmul_dense_vec")
def _probe_dist_matvec(ctx):
    from repro_torch.core.dist_assoc import _matvec_prog

    loc = _dist(ctx).local
    x = torch.ones(_NKEYS, dtype=torch.float32, device=ctx.device)
    yield "matvec", functools.partial(
        _matvec_prog, ctx.mesh, _plus_times(), _NKEYS, torch.float32,
        loc.rows, loc.cols, loc.vals, x)


# --------------------------------------------------------------------------
# Serve path: the server's execution entry point dispatches the same
# programs as the eager layers, so its contract is checked over the
# shard-local programs a query mix reaches — selection (range + gather
# dispatch kinds), ewise ⊕, and the replicated-B product of a hot
# `A[sel, :] @ B` query.  (The fused matmul-*reduce* carries its one
# all-reduce and is budgeted under DistAssoc.matmul_reduce; the serve
# contract asserts the serve layer itself ADDS no collective.)
# --------------------------------------------------------------------------

@probe_for("serve.execute")
def _probe_serve_execute(ctx):
    from repro_torch.core.dist_assoc import (_ewise_prog, _matmul_prog,
                                             _select_prog)
    from repro_torch.core.plan import PLAN_STATS
    from repro_torch.serve.engine import serve_execute

    for label, a, compiled in _dist_selections(ctx, ("range", "gather")):
        yield f"select-{label}", functools.partial(_select_prog, a.local,
                                                   *compiled)
    yield "ewise-add", functools.partial(_ewise_prog, a.local, a.local,
                                         _plus_times(), "add")
    _, _, am, bm = _product_setup(ctx)
    yield "matmul", functools.partial(_matmul_prog, _plus_times(), 256, 256,
                                      *am, *bm)

    def query():
        # a repeated query arrives as a new graph of the same structure
        sel = _selector_kinds()[0][1]
        serve_execute(a.lazy()[sel] + a.lazy()[sel])

    # repeated identical serve queries must not plan again
    yield RetraceAudit(label="serve-repeat-query", first=query, again=query,
                       size=lambda: PLAN_STATS["plan_misses"])


# --------------------------------------------------------------------------
# Sharded-B distribution strategies (exact collective budgets: the cost
# model may only ever choose between programs that are provably no
# chattier than declared — replicate 0, all_to_all 1, 2D pc−1).  The
# JAX audits watch each program factory's lru_cache: the port's programs
# are plain functions, built once.
# --------------------------------------------------------------------------

def _a2a_args(ctx):
    """Every rank's A (gathered, a prologue collective) and this rank's
    contraction block of B with its rank map."""
    a, st, _, _ = _product_setup(ctx)
    return a, (*a._gathered_a(st), *a._a2a_b_operand(st, _plus_times()))


@probe_for("dist.matmul_all_to_all")
def _probe_dist_matmul_a2a(ctx):
    from repro_torch.core.dist_assoc import _matmul_a2a_prog
    from repro_torch.core.spgemm import _upload

    a, args = _a2a_args(ctx)
    bounds = _upload(a.row_bounds, ctx.device, torch.int64)
    yield "a2a-exchange", functools.partial(
        _matmul_a2a_prog, ctx.mesh, _plus_times(), 256, _CAP, 256, *args,
        bounds)


@probe_for("dist.matmul_2d")
def _probe_dist_matmul_2d(ctx):
    from repro_torch.core.dist_assoc import _matmul_ring_prog

    p = ctx.mesh.size
    if p % _RING_PC:
        yield NotRun(label="ring", reason=(
            f"{p} rank(s) hold no (pr, {_RING_PC}) grid: the declared 3 "
            f"collectives are the pc − 1 ring shifts of a pc = "
            f"{_RING_PC} grid (the JAX probe's 2 × 4), and one rank makes "
            f"none; run it on 4 ranks (--ranks 4)"))
        return
    pr = p // _RING_PC
    a, st, am, _ = _product_setup(ctx)
    blk = a._stage_b_blocks(st, _plus_times(), pr, _RING_PC, _CAP)
    yield f"ring-{pr}x{_RING_PC}", functools.partial(
        _matmul_ring_prog, ctx.mesh, _plus_times(), pr, _RING_PC, 256, 256,
        *am, *blk)


@probe_for("dist.matmul_reduce_all_to_all")
def _probe_dist_matmul_reduce_a2a(ctx):
    from repro_torch.core.dist_assoc import _matmul_reduce_a2a_prog

    _, args = _a2a_args(ctx)
    for axis in (1, 0):
        yield f"axis{axis}", functools.partial(
            _matmul_reduce_a2a_prog, ctx.mesh, _plus_times(), 256, _NKEYS,
            axis, *args)


def _bsr_operands(ctx):
    """The JAX probe's tile geometry: each rank's 64 A entries in two
    tiles (its first block-row, k tiles 0 and 1), B's 64 entries in two
    tiles ((0, 0) and (1, 1)): two pairs and two C tiles a rank."""
    from repro_torch.core.assoc_tensor import AssocTensor
    from repro_torch.core.dist_assoc import DistAssoc

    keys, space = _keys(), _space()
    rng = np.random.default_rng(_SEED)
    p = ctx.mesh.size
    lo = np.repeat(np.arange(p) * (_NKEYS // p), _CAP)
    ar = lo + rng.integers(0, _TILE, _CAP * p)
    ac = rng.integers(0, 2 * _TILE, _CAP * p)
    av = (rng.integers(1, 9, _CAP * p) / 4).astype(np.float32)
    a = DistAssoc.from_triples(keys[ar], keys[ac], av, ctx.mesh,
                               aggregate="max", capacity_per_shard=_CAP,
                               row_space=space, col_space=space,
                               device=ctx.device)
    br = rng.integers(0, 2 * _TILE, _CAP)
    bc = br // _TILE * _TILE + rng.integers(0, _TILE, _CAP)
    bv = (rng.integers(1, 9, _CAP) / 4).astype(np.float32)
    b = AssocTensor.from_triples(keys[br], keys[bc], bv, aggregate="max",
                                 capacity=_CAP, row_space=space,
                                 col_space=space, device=ctx.device)
    return a, a._matmul_setup(b)


@probe_for("dist.matmul_bsr")
def _probe_dist_matmul_bsr(ctx):
    from repro_torch.core.dist_assoc import _matmul_bsr_prog
    from repro_torch.core.spgemm import _upload, pack_b_tiles

    a, st = _bsr_operands(ctx)
    sr, plan = _plus_times(), a._bsr_plan(st)
    a_vals = st.a_loc.vals[_upload(a._a_valid(st), ctx.device)].float()
    yield "bsr-one-program", functools.partial(
        _matmul_bsr_prog, sr, plan, a_vals, pack_b_tiles(plan, st.b_vals, sr),
        256, "auto")


# --------------------------------------------------------------------------
# Dynamic ingest (repro_torch.ingest): the LSM write/read path.  The
# append canonicalize and both merge-on-read programs must be
# zero-collective (delta batches are pre-routed to their owning row shard
# on host) and never densify (the overlay output is O(capb + capd), never
# O(nr·nc)).  The JAX audits watch the program factories' lru_caches; the
# port's merge programs are plain functions and cache nothing.
# --------------------------------------------------------------------------

@probe_for("ingest.append")
def _probe_ingest_append(ctx):
    from repro_torch.ingest.merge import delta_canon

    yield "delta-canon", functools.partial(delta_canon, *_raw_delta(ctx),
                                           "sum")


@probe_for("ingest.merge_read")
def _probe_ingest_merge_read(ctx):
    from repro_torch.ingest.merge import _merge_read_prog

    t = _device_tensor(ctx)
    yield "overlay-merge", functools.partial(
        _merge_read_prog, t.rows, t.cols, t.vals, *_raw_delta(ctx), _NKEYS,
        "sum")


@probe_for("ingest.dist_merge_read")
def _probe_ingest_dist_merge(ctx):
    from repro_torch.ingest.merge import dist_merge

    a = _dist(ctx)
    lo, hi = (int(x) for x in a.row_bounds[ctx.mesh.rank:ctx.mesh.rank + 2])
    delta = _raw_delta(ctx, lo, hi)           # routed to this rank's rows
    kmap = torch.arange(_NKEYS, dtype=torch.int32, device=ctx.device)
    for label, rerank in (("shard-local", False), ("reranked", True)):
        yield label, functools.partial(dist_merge, a.local, *delta, kmap,
                                       kmap, "sum", rerank)
