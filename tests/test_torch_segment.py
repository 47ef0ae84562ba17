"""The segmented scan (``segment_scan``/``aggregate_runs``): the port's
plain version against the JAX package's oracle and its Pallas kernel in
interpret mode, for the three combines, on sizes that are not multiples of
256 and with runs that cross the Pallas kernel's 256- and 1024-element
block boundaries; and the CUDA kernel's order model
(``segment_scan_tiled_ref``) against the same, with its depth bound.

``min``/``max`` agree exactly; ``sum`` is taken in another order by each
version, so sums agree to 1e-5.  The CUDA kernel runs in
``test_torch_cuda.py`` on a card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import ops as j_ops
from repro.kernels.segment_reduce.ref import segment_scan_ref
from repro_torch.kernels.segment_reduce import ops as t_ops
from repro_torch.kernels.segment_reduce import ref as t_ref_mod
from repro_torch.kernels.segment_reduce.ref import segment_scan_ref as t_ref

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401

COMBINES = ("sum", "min", "max")
t_ref_bound = t_ref_mod.segment_scan_sum_bound
t_depth = t_ref_mod.segment_scan_depth
j_ref = jax.jit(segment_scan_ref, static_argnames="combine")


def runs_input(n, seed, max_run=600):
    """Sorted int32 keys in runs of 1 to ``max_run`` (long runs straddle
    the 256/1024 boundaries) and normal fp32 values."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_run + 1, n)
    keys = np.repeat(np.arange(n), lengths)[:n]
    keys = (keys * 3 - 50).astype(np.int32)       # gaps, negative keys
    return keys, rng.normal(size=n).astype(np.float32)


def assert_scan(got, want, combine):
    if combine == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


SCAN_CASES = [(1, 1), (255, 40), (1000, 600), (2100, 300), (3000, 900)]


def scan_pallas_runs(n):
    """The Pallas kernel (interpret mode) takes a padded size that is at
    most 1024 or a multiple of 1024 (its wrapper asserts so at 2100)."""
    return -(-n // 256) * 256 <= 1024 or -(-n // 256) % 4 == 0


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n,max_run", SCAN_CASES)
def test_segment_scan_matches_jax(n, max_run, combine):
    keys, vals = runs_input(n, n, max_run)
    got = t_ops.segment_scan(torch.from_numpy(keys), torch.from_numpy(vals),
                             combine=combine).numpy()
    assert_scan(got, j_ref(jnp.asarray(keys), jnp.asarray(vals),
                           combine=combine), combine)
    if scan_pallas_runs(n):
        pallas = j_ops.segment_scan(jnp.asarray(keys), jnp.asarray(vals),
                                    combine=combine, impl="interpret")
        assert_scan(got, pallas, combine)


@pytest.mark.parametrize("combine", COMBINES)
def test_aggregate_runs_matches_jax(combine):
    keys, vals = runs_input(1500, 7, 50)
    tk, tv, th = t_ops.aggregate_runs(torch.from_numpy(keys),
                                      torch.from_numpy(vals), combine=combine)
    jk, jv, jh = j_ops.aggregate_runs(jnp.asarray(keys), jnp.asarray(vals),
                                      combine=combine, impl="ref")
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(th.numpy(), jh)
    assert_scan(tv.numpy(), jv, combine)


def test_aggregate_runs_small_case():
    keys = torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32)
    vals = torch.tensor([1., 2., 5., 1., 1., 1.])
    _, v, heads = t_ops.aggregate_runs(keys, vals, combine="sum")
    assert heads.tolist() == [True, False, True, True, False, False]
    assert v.tolist() == [3.0, 0.0, 5.0, 3.0, 0.0, 0.0]
    k, v, heads = t_ops.aggregate_runs(keys[:0], vals[:0])
    assert k.numel() == v.numel() == heads.numel() == 0


@pytest.mark.parametrize("combine", COMBINES)
def test_kernel_route_padding_keeps_every_output(combine):
    """The kernel route's pad (to a multiple of 256, key 2^31-1, value 0)
    comes after every real element, so the scan of the padded arrays cut
    back to n is the scan of the inputs, also when the last real key is
    the pad key itself."""
    keys, vals = runs_input(700, 3, 30)
    keys[-5:] = 2 ** 31 - 1
    kp, vp = t_ops.pad_for_kernel(torch.from_numpy(keys),
                                  torch.from_numpy(vals))
    assert kp.shape[0] == 768 and kp.dtype == torch.int32
    assert int(kp[-1]) == 2 ** 31 - 1 and float(vp[-1]) == 0.0
    np.testing.assert_array_equal(
        t_ref(kp, vp, combine=combine)[:700].numpy(),
        t_ref(torch.from_numpy(keys), torch.from_numpy(vals),
              combine=combine).numpy())


def test_dispatch_never_falls_back():
    keys = torch.zeros(4, dtype=torch.int32)
    vals = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.segment_scan(keys, vals, impl="cuda")
    with pytest.raises(ValueError, match="unknown combine"):
        t_ops.segment_scan(keys, vals, combine="prod")
    assert t_ops.segment_scan(keys[:0], vals[:0]).numel() == 0


# -- the kernel's order model (segment_scan_tiled_ref) ------------------------------

# (n, max_run, tile): runs across tile edges, at the kernel's 4096 and at
# 256 (E = 1 a thread), where a few thousand elements reach the look-back's
# second and third levels (more than 32 and 1024 tiles); max_run = n makes
# a few runs over many tiles each, None one run over every tile
TILED_CASES = [(1, 1, 4096), (700, 30, 4096), (9000, 600, 4096),
               (20000, 20000, 4096), (20000, None, 4096), (9000, 40, 256),
               (9000, 9000, 256), (300000, 300000, 256), (300000, None, 256),
               (40000, 3, 512)]


def tiled_input(n, max_run, seed, quarters=False, specials=False):
    """Sorted keys in runs of 1..max_run (None: one run), and normal values
    (or quarters); ``specials``: NaN, +inf and -inf at seeded places."""
    rng = np.random.default_rng(seed)
    if max_run is None:
        lengths = np.array([n])
    else:
        lengths = rng.integers(1, max_run + 1, 2 * n // (max_run + 1) + 10)
    while lengths.sum() < n:
        lengths = np.concatenate([lengths, rng.integers(1, max_run + 1, 10)])
    keys = np.repeat(np.arange(lengths.shape[0]), lengths)[:n]
    keys = (keys * 3 - 50).astype(np.int32)
    vals = (rng.integers(1, 9, n) / 4 if quarters
            else rng.normal(size=n)).astype(np.float32)
    if specials:
        for v in (np.nan, np.inf, -np.inf, np.nan):
            vals[rng.integers(0, n)] = v
    return keys, vals


def exact_scan(keys, vals):
    """The sum scan in fp64, run by run."""
    head = np.ones(keys.shape[0], bool)
    head[1:] = keys[1:] != keys[:-1]
    out = vals.astype(np.float64)
    for i in np.flatnonzero(~head):
        out[i] += out[i - 1]
    return out


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles):
    """The JAX side of the parametrised scans (the oracle and the Pallas
    kernel in interpret mode), run first on threads so that their programs
    compile side by side; each test then makes the same calls."""
    inputs = [(runs_input(n, n, max_run), n, COMBINES)
              for n, max_run in SCAN_CASES]
    for n, max_run, tile in TILED_CASES:
        for quarters in (False, True):
            combines = COMBINES if quarters else ("min", "max")
            inputs.append((tiled_input(n, max_run, n + tile, quarters,
                                       specials=True), n, combines))
    calls = []
    for (keys, vals), n, combines in inputs:
        jk, jv = jnp.asarray(keys), jnp.asarray(vals)
        for combine in combines:
            calls.append(functools.partial(j_ref, jk, jv, combine=combine))
            if n <= 20000 and scan_pallas_runs(n):
                calls.append(functools.partial(
                    j_ops.segment_scan, jk, jv, combine=combine,
                    impl="interpret"))
    warm_jax(calls)


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n,max_run,tile", TILED_CASES)
def test_tiled_ref_matches_jax(n, max_run, tile, combine):
    """min/max (normal values, NaN and ±inf among them) and sums of
    quarters equal the JAX oracle and, where it runs, the Pallas kernel in
    interpret mode; a NaN reaches the rest of its run and nothing else."""
    for quarters in (False, True):
        keys, vals = tiled_input(n, max_run, n + tile, quarters,
                                 specials=combine != "sum" or quarters)
        got = t_ref_mod.segment_scan_tiled_ref(torch.from_numpy(keys),
                                           torch.from_numpy(vals),
                                           combine=combine, tile=tile)
        if combine == "sum" and not quarters:
            continue                    # rounding: the bound test below
        want = j_ref(jnp.asarray(keys), jnp.asarray(vals), combine=combine)
        np.testing.assert_array_equal(got.numpy(), want)
        if n <= 20000 and scan_pallas_runs(n):
            np.testing.assert_array_equal(got.numpy(), j_ops.segment_scan(
                jnp.asarray(keys), jnp.asarray(vals), combine=combine,
                impl="interpret"))


@pytest.mark.parametrize("n,max_run,tile", TILED_CASES)
def test_tiled_ref_sum_within_depth_bound(n, max_run, tile):
    """Sums of normal values within γ_d(i)·Σ|v| of the fp64 scan, d(i) the
    model's depth; and the stated closed form of d(i): at most E + 9 after
    a tile's first head, E + 14 + 5·(levels - 1) in its leading run."""
    keys, vals = tiled_input(n, max_run, 7 * n + tile)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    got = t_ref_mod.segment_scan_tiled_ref(tk, tv, tile=tile).double()
    err = (got - torch.from_numpy(exact_scan(keys, vals))).abs()
    assert bool((err <= t_ref_bound(tk, tv, tile=tile,
                                    against="exact")).all())
    # against the plain version: both sides' bounds
    plain = t_ref(tk, tv).double()
    assert bool(((got - plain).abs() <= t_ref_bound(tk, tv, tile=tile)).all())
    depth = t_depth(tk, tile=tile)
    per = tile // 256
    tiles = -(-n // tile)
    levels = 1
    while 32 ** levels < tiles:
        levels += 1
    head = np.ones(n, bool)
    head[1:] = keys[1:] != keys[:-1]
    lead = np.zeros(n, bool)
    for t0 in range(0, n, tile):
        h = np.flatnonzero(head[t0:t0 + tile])
        lead[t0:t0 + (h[0] if h.size else tile)] = t0 > 0
    assert int(depth[~torch.from_numpy(lead)].max()) <= per + 9
    assert int(depth.max()) <= per + 14 + 5 * (levels - 1)


def test_tiled_ref_unsorted_runs_and_nan():
    """Runs are stretches of adjacent equal keys (a key may come back); a
    NaN under min/max, or inf - inf in a sum, stays inside its run."""
    keys = torch.tensor([5, 5, 5, 2, 2, 5, 5, 7], dtype=torch.int32)
    nan, inf = float("nan"), float("inf")
    vals = torch.tensor([1., nan, 2., 3., 4., 0.5, 6., inf])
    for tile in (256, 4096):
        mn = t_ref_mod.segment_scan_tiled_ref(keys, vals, combine="min", tile=tile)
        torch.testing.assert_close(
            mn, torch.tensor([1., nan, nan, 3., 3., .5, .5, inf]),
            rtol=0, atol=0, equal_nan=True)
        sm = t_ref_mod.segment_scan_tiled_ref(
            keys, torch.tensor([1., inf, -inf, 3., 4., inf, 1., 2.]),
            tile=tile)
        torch.testing.assert_close(
            sm, torch.tensor([1., inf, nan, 3., 7., inf, inf, 2.]),
            rtol=0, atol=0, equal_nan=True)


def test_scratch_words_and_epochs():
    """Status words: a tile's each, then one level of group summaries per
    factor of 32 tiles.  A (device, stream) keeps one buffer: zeroed when
    new or grown and when its epochs are spent, else reused with the next
    epoch, never 0."""
    tile = t_ops.TILE
    assert t_ops.scratch_words(0) == 0
    assert t_ops.scratch_words(1) == 1
    assert t_ops.scratch_words(32 * tile) == 32
    assert t_ops.scratch_words(32 * tile + 1) == 33 + 2
    assert t_ops.scratch_words(1025 * tile) == 1025 + 33 + 2
    assert t_ops.scratch_words(2 ** 21) == 512 + 16
    assert t_ops.scratch_words(2 ** 24) == 4096 + 128 + 4
    key = ("cpu", -1)                   # a stream no card call uses
    try:
        buf, a = t_ops.status_words(4096, *key)
        assert a == 1 and buf.dtype == torch.int64 and buf.numel() == 1
        assert not buf.any()
        buf.fill_(-1)                   # words an earlier call left
        again, b = t_ops.status_words(4096, *key)
        assert again is buf and b == 2 and bool((buf == -1).all())
        grown, c = t_ops.status_words(33 * tile, *key)
        assert grown.numel() == 33 + 2 and c == 1 and not grown.any()
        grown.fill_(-1)
        small, d = t_ops.status_words(4096, *key)   # a prefix serves
        assert small is grown and d == 2
        t_ops._status[key] = (grown, t_ops.EPOCH_MAX - 1)
        assert t_ops.status_words(4096, *key)[1] == t_ops.EPOCH_MAX
        assert bool((grown == -1).all())
        wrapped, e = t_ops.status_words(4096, *key)  # spent: zeroed, at 1
        assert wrapped is grown and e == 1 and not grown.any()
    finally:
        t_ops._status.pop(key, None)
