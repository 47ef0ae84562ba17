"""The TF32 route's arithmetic on the CPU: a numpy model of the three-pass
product of ``csrc/semiring_tf32_sm90.cu`` (hi and lo rounded to TF32 by bit
operations, the kernel's pass order, each 32-deep slab summed afresh with
every addition truncated to fp32 as the tensor cores may do, the slab sums
added in fp32 round-to-nearest, the exact path for flagged rows and
columns), held against fp64 and the plain version; the same model over a
block-masked A, as the kernel walks each block-row's present k tiles for
``bsr_spgemm``; over a run of tile pairs, as
``csrc/bsr_pairlist_tf32_sm90.cu`` splits each pair's tiles in the kernel;
and the wrappers' choice of route.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import REGISTRY
from repro_torch.kernels import LAUNCHES, cuda_lib
from repro_torch.kernels.bsr_spgemm import ops as t_bsr
from repro_torch.kernels.bsr_spgemm.ref import (bsr_spgemm_ref,
                                                bsr_spgemm_tf32x3_error_bound,
                                                masked_nonfinite_operands)
from repro_torch.kernels.semiring_matmul import ops as t_sm
from repro_torch.kernels.semiring_matmul.ref import (nonfinite_operands,
                                                     semiring_matmul_ref,
                                                     tf32x3_error_bound)

from _torch_helpers import SEMIRINGS

HUGE_ABS = 2.0 ** 62   # the split's limit: larger entries take the exact path


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round fp32 to 10 explicit mantissa bits, to
    nearest with ties away from zero (add half of the 13 dropped bits to
    the magnitude, then clear them); inf and NaN pass through."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    r = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(x), r, x).astype(np.float32)


def split(x: np.ndarray):
    with np.errstate(invalid="ignore", over="ignore"):
        hi = tf32_rna(x)
        lo = np.where(np.isfinite(hi), tf32_rna(x - hi), np.float32(0))
    return hi, lo.astype(np.float32)


def add_truncated(acc: np.ndarray, t: np.ndarray) -> np.ndarray:
    """acc + t rounded toward zero to fp32 (the tensor core's accumulation
    taken as truncating)."""
    s = acc.astype(np.float64) + t
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def model(a: np.ndarray, b: np.ndarray, passes: int = 3,
          exact_path: bool = True, slab: int = 32,
          col_flags=None) -> np.ndarray:
    """The kernel's product: per k8 step A_lo·B_hi, A_hi·B_lo, then
    A_hi·B_hi (``passes=1``: A_hi·B_hi alone), each tf32 x tf32 product
    exact, each addition into the slab's sum truncated; the slab sums
    (``slab`` deep; ``slab=K``: one long sum) added rounded to nearest;
    then outputs on a flagged row of A or column of B (``col_flags``: the
    columns flagged elsewhere) recomputed in fp32 FMA in k order."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    (ah, al), (bh, bl) = split(a), split(b)
    order = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    kk = a.shape[1]
    with np.errstate(invalid="ignore", over="ignore"):
        for s0 in range(0, kk, slab):
            d = np.zeros_like(acc)
            for k8 in range(s0, min(s0 + slab, kk), 8):
                for x, y in order:
                    for k in range(k8, min(k8 + 8, kk)):
                        d = add_truncated(d, np.multiply.outer(
                            x[:, k].astype(np.float64),
                            y[k].astype(np.float64)))
            acc = (acc + d).astype(np.float32)
        if exact_path:
            rows = ~(np.abs(a) <= HUGE_ABS).all(axis=1)
            cols = (~(np.abs(b) <= HUGE_ABS).all(axis=0) if col_flags is None
                    else col_flags)
            for i, j in zip(*np.nonzero(rows[:, None] | cols[None, :])):
                s = np.float32(0)
                for k in range(a.shape[1]):   # fmaf: one rounding
                    s = np.float32(np.float64(a[i, k]) * np.float64(b[k, j])
                                   + np.float64(s))
                acc[i, j] = s
    return acc


def bound(a, b):
    return tf32x3_error_bound(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1)
    x = np.array([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                  3.0, 0.25, np.finfo(np.float32).max, -np.inf, 2 ** -130],
                 np.float32)
    want = np.array([1 + 2 ** -10, one, -(1 + 2 ** -10), 1 + 2 ** -9, 3.0, 0.25,
                     np.inf, -np.inf, tf32_rna(np.float32(2 ** -130))],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    # the low 13 bits are clear: what wgmma reads is the value itself
    assert not (tf32_rna(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)).view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("kind,k", [("integers", 64), ("quarters", 4096)])
def test_model_is_exact_on_tf32_values(kind, k):
    """Integers 1..100 (the D4M workloads) and multiples of 1/4 in [1/4, 2]
    (the kernel checks) are TF32 values: lo = 0 and every partial sum fits
    in 24 bits, so the product is exact."""
    rng = np.random.default_rng(k)
    if kind == "integers":
        a = rng.integers(1, 101, (12, k)).astype(np.float32)
        b = rng.integers(1, 101, (k, 10)).astype(np.float32)
    else:
        a = (rng.integers(1, 9, (6, k)) / 4).astype(np.float32)
        b = (rng.integers(1, 9, (k, 5)) / 4).astype(np.float32)
    assert not split(a)[1].any() and not split(b)[1].any()
    np.testing.assert_array_equal(model(a, b), a.astype(np.float64) @ b)


@pytest.mark.parametrize("k", [32, 4096, 4099])
def test_model_within_bound_on_normal_values(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((8, k)).astype(np.float32)
    b = rng.standard_normal((k, 6)).astype(np.float32)
    want = a.astype(np.float64) @ b
    err = np.abs(model(a, b) - want)
    assert (err <= bound(a, b)).all()
    assert np.linalg.norm(model(a, b) - want) / np.linalg.norm(want) < 2 ** -16


def test_one_truncating_sum_would_lose_the_lo_passes():
    """Why each slab starts a fresh sum: one 3K-long truncating sum loses
    up to an ulp of it at every small lo product, and at K = 4096 ends as
    far from the fp64 product as one pass does."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 4)).astype(np.float32)
    want = a.astype(np.float64) @ b

    def rel(x):
        return np.linalg.norm(x - want) / np.linalg.norm(want)
    assert rel(model(a, b, slab=4096)) > 2 ** -16 > 8 * rel(model(a, b))


def test_bound_breaks_without_the_lo_passes():
    """One pass (A_hi·B_hi) leaves 2^-11-relative errors per operand: the
    element-wise bound breaks at K = 32, and the relative L2 limit of the
    card checks (2^-16) at K = 4096.  This is what catches a kernel that drops the lo passes."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    err = np.abs(model(a, b, passes=1) - a.astype(np.float64) @ b)
    assert (err > bound(a, b)).any()
    a = rng.standard_normal((4, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 4)).astype(np.float32)
    want = a.astype(np.float64) @ b
    rel = np.linalg.norm(model(a, b, passes=1) - want) / np.linalg.norm(want)
    assert rel > 2 ** -16


def test_nonfinite_inputs_follow_the_plain_version():
    """±inf, NaN and overflow: the exact path gives the plain version's
    values (fp32 matmul), inf where it has inf and NaN only where it has
    NaN; the split product alone would give NaN (an inf times a lo part of
    0) where the plain version has ±inf."""
    ta, tb = nonfinite_operands(96, 88, 90, torch.Generator().manual_seed(2),
                                "cpu")
    a, b = ta.numpy(), tb.numpy()
    want = semiring_matmul_ref(ta, tb).numpy()
    assert np.isinf(want).any() and np.isnan(want).any()
    np.testing.assert_array_equal(model(a, b), want)   # NaN == NaN here
    alone = model(a, b, exact_path=False)
    assert (np.isnan(alone) & np.isinf(want)).any()


def test_error_bound_formula():
    a = torch.tensor([[1.0, -2.0], [0.5, 4.0]])
    b = torch.tensor([[3.0], [-1.0]])
    scale = 52 * 2.0 ** -22 + 1 * 2.0 ** -24      # K = 2: one slab
    torch.testing.assert_close(tf32x3_error_bound(a, b),
                               scale * torch.tensor([[5.0], [5.5]],
                                                    dtype=torch.float64))


def test_route_follows_the_semiring_and_never_falls_back():
    """(+, ×) takes the TF32 route, the other five the CUDA-core ring; a
    CPU tensor runs the plain version under auto and raises under cuda,
    for both routes, with no launch counted."""
    assert {s: t_sm.route(REGISTRY[s]) for s in SEMIRINGS} == {
        s: ("tf32x3" if s == "plus_times" else "ring") for s in SEMIRINGS}
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(1, 9, (130, 70)).astype(np.float32))
    b = torch.from_numpy(rng.integers(1, 9, (70, 40)).astype(np.float32))
    mask = torch.ones((1, 1), dtype=torch.int32)
    d = torch.ones((128, 128))
    before = dict(LAUNCHES)
    for s in SEMIRINGS:
        assert torch.equal(t_sm.semiring_matmul(a, b, semiring=s),
                           semiring_matmul_ref(a, b, semiring=s))
        with pytest.raises(ValueError, match="CUDA tensors"):
            t_sm.semiring_matmul(a, b, semiring=s, impl="cuda")
        with pytest.raises(ValueError, match="CUDA tensors"):
            t_bsr.bsr_spgemm_reduce(d, mask, d, axis=1, semiring=s,
                                    impl="cuda")
        with pytest.raises(ValueError, match="CUDA tensors"):
            t_bsr.bsr_spgemm(d, mask, d, semiring=s, impl="cuda")
    assert dict(LAUNCHES) == before
    # the route's scratch: split operands and zeroed flags
    scratch, flags = t_sm.tf32_scratch(256, 128, 64, "cpu")
    assert scratch.shape == (2 * (256 + 128) * 64,)
    assert flags.shape == (384,) and not flags.any()


# -- bsr_spgemm: a block-masked A ------------------------------------------------

def masked_model(a, mask, b, bm=128):
    """The store kernel under a block mask: each block-row (``bm`` rows)
    against only its present 128-wide k tiles (the split pass skips the
    absent ones), so the dense model with K = 128 x present tiles; B's
    columns flagged over all of B, as the split pass flags them; a
    block-row with no present tile stays 0."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    col_flags = ~(np.abs(b) <= HUGE_ABS).all(axis=0)
    for i, row in enumerate(mask):
        ks = np.concatenate([np.arange(128 * t, 128 * t + 128)
                             for t in np.nonzero(row)[0]] + [[]]).astype(int)
        if len(ks):
            out[i * bm:(i + 1) * bm] = model(a[i * bm:(i + 1) * bm][:, ks],
                                             b[ks], col_flags=col_flags)
    return out


def test_masked_model_within_bound_with_present_k():
    """Normal values: within the dense bound with K = 128 x the
    block-row's present k tiles (``bsr_spgemm_tf32x3_error_bound``), and
    an empty block-row exactly 0 (its bound is 0)."""
    rng = np.random.default_rng(30)
    bm = 4   # rows per block-row: only the k tiles shape the error
    mask = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0]], np.int32)
    a = rng.standard_normal((3 * bm, 512)).astype(np.float32)
    b = rng.standard_normal((512, 6)).astype(np.float32)
    got = masked_model(a, mask, b, bm=bm)
    full = np.repeat(np.repeat(mask, bm, 0), 128, 1) != 0
    want = np.where(full, a, 0).astype(np.float64) @ b
    tol = bsr_spgemm_tf32x3_error_bound(torch.from_numpy(a),
                                        torch.from_numpy(mask),
                                        torch.from_numpy(b), bm=bm).numpy()
    assert (np.abs(got - want) <= tol).all()
    assert not got[bm:2 * bm].any() and not tol[bm:2 * bm].any()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2 ** -16
    # K = 128 x present: block-row 2's one tile is 4 slabs, not 16
    mag = np.abs(np.where(full, a, 0)).astype(np.float64) @ np.abs(b)
    assert np.allclose(tol[2 * bm:] / mag[2 * bm:],
                       52 * 2.0 ** -22 + 4 * 2.0 ** -24)


def test_masked_model_nonfinite_follows_the_plain_version():
    """±inf, NaN and entries above 2^62 in present and in absent tiles
    (``masked_nonfinite_operands``): the exact path over the present k
    tiles gives the plain version's values, NaN where it has NaN."""
    ta, tm, tb = masked_nonfinite_operands(
        256, 384, 90, torch.Generator().manual_seed(31), "cpu")
    want = bsr_spgemm_ref(ta, tm, tb).numpy()
    assert np.isinf(want).any() and np.isnan(want).any()
    got = masked_model(ta.numpy(), tm.numpy(), tb.numpy())
    np.testing.assert_array_equal(got, want)   # NaN == NaN here


# -- the pair-list kernels: a run of tile pairs ----------------------------------

def run_model(a_tiles, b_tiles, pairs, **kw):
    """The pair kernel's product over one run: for each pair its four
    32-deep slabs, each split in the kernel and summed afresh into d, d
    added to the accumulator rounded to nearest; then the exact path for a
    row of any A tile or column of any B tile of the run that holds a value
    the split cannot carry, in fp32 FMA in k order over the pairs.  A slab
    never straddles two pairs (128 is a multiple of 32), so this is the
    dense model of the run's A tiles side by side against its B tiles
    stacked: K = 128 x pairs."""
    a = np.concatenate([a_tiles[i] for i, _ in pairs], axis=1)
    b = np.concatenate([b_tiles[j] for _, j in pairs], axis=0)
    return model(a, b, **kw), a, b


# runs of the pair kernels: one pair, the n=18 product's longest plain run
# (4), the n=18 reduce's longest run (95); the tiles keep 128 k and cut
# rows and columns (independent outputs) to keep the model quick
RUN_LENGTHS = (1, 4, 95)


def _run_tiles(rng, n_pairs, kind, rows=6, cols=5):
    n_a, n_b = 7, 9
    if kind == "integers":   # 1..30: 95 pairs of them stay below 2^24
        at = rng.integers(1, 31, (n_a, rows, 128)).astype(np.float32)
        bt = rng.integers(1, 31, (n_b, 128, cols)).astype(np.float32)
    elif kind == "quarters":
        at = (rng.integers(1, 9, (n_a, rows, 128)) / 4).astype(np.float32)
        bt = (rng.integers(1, 9, (n_b, 128, cols)) / 4).astype(np.float32)
    else:
        at = rng.standard_normal((n_a, rows, 128)).astype(np.float32)
        bt = rng.standard_normal((n_b, 128, cols)).astype(np.float32)
    pairs = list(zip(rng.integers(0, n_a, n_pairs), rng.integers(0, n_b, n_pairs)))
    return at, bt, pairs


@pytest.mark.parametrize("n_pairs", RUN_LENGTHS)
@pytest.mark.parametrize("kind", ["integers", "quarters"])
def test_run_model_is_exact_on_tf32_values(kind, n_pairs):
    """Integers (the main path's are 1.0) and the kernel checks' quarters:
    lo = 0 and every partial sum below 2^24, so a run is exact, 95 pairs
    (K = 12,160) included."""
    rng = np.random.default_rng(100 + n_pairs)
    at, bt, pairs = _run_tiles(rng, n_pairs, kind)
    got, a, b = run_model(at, bt, pairs)
    want = a.astype(np.float64) @ b
    assert np.abs(want).max() < 2 ** 24
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pairs", RUN_LENGTHS)
def test_run_model_within_bound_on_normal_values(n_pairs):
    """The dense route's bound (tf32x3_error_bound) with K = 128 x pairs
    and |A|·|B| summed over the run."""
    rng = np.random.default_rng(200 + n_pairs)
    at, bt, pairs = _run_tiles(rng, n_pairs, "normal")
    got, a, b = run_model(at, bt, pairs)
    want = a.astype(np.float64) @ b
    assert a.shape[1] == 128 * n_pairs
    assert (np.abs(got - want) <= bound(a, b)).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2 ** -16
    # a fused reduce adds the fold of 128 outputs in fp32: (n - 1) · 2^-24
    # of their magnitude sum, within the 128 · 2^-23 the card tests allow
    fold = got.sum(axis=1, dtype=np.float32)
    tol = bound(a, b).sum(axis=1) + 128 * 2.0 ** -23 * np.abs(want).sum(axis=1)
    assert (np.abs(fold - want.sum(axis=1)) <= tol).all()


@pytest.mark.parametrize("n_pairs", [1, 3])
def test_run_model_nonfinite_follows_the_plain_version(n_pairs):
    """±inf, NaN and overflow in any tile of the run: the exact path over
    the run's pairs gives the plain version's values; the split alone would
    not."""
    ta, tb = nonfinite_operands(96, 128 * n_pairs, 90,
                                torch.Generator().manual_seed(20 + n_pairs),
                                "cpu")
    a, b = ta.numpy(), tb.numpy()
    at = a.reshape(96, n_pairs, 128).transpose(1, 0, 2)
    bt = b.reshape(n_pairs, 128, 90)
    pairs = [(i, i) for i in range(n_pairs)]
    want = semiring_matmul_ref(ta, tb).numpy()
    got, _, _ = run_model(at, bt, pairs)
    np.testing.assert_array_equal(got, want)   # NaN == NaN here
    alone, _, _ = run_model(at, bt, pairs, exact_path=False)
    assert (np.isnan(alone) & np.isinf(want)).any()


# -- which semiring has a kernel ------------------------------------------------

@pytest.mark.parametrize("name", SEMIRINGS)
def test_kernel_semiring_id_takes_the_registry(name):
    sr = REGISTRY[name]
    sid = cuda_lib.kernel_semiring_id(sr)
    assert sid == cuda_lib.SEMIRING_IDS[name]
    assert t_sm.route(sr) == ("tf32x3" if sid == 0 else "ring")


@pytest.mark.parametrize("base", SEMIRINGS)
def test_mxu_semiring_keeps_the_tf32_route(base):
    """Any semiring with mxu=True is a multiply-accumulate that the JAX
    kernels send to jnp.dot: it keeps the TF32 route, registered or not."""
    sr = dataclasses.replace(REGISTRY[base], name=f"{base}_dot", mxu=True)
    assert cuda_lib.kernel_semiring_id(sr) == 0
    assert t_sm.route(sr) == "tf32x3"


def _off_registry():
    return {
        "unregistered name": dataclasses.replace(REGISTRY["max_plus"],
                                                 name="my_max_plus"),
        "min_plus with another ⊗": dataclasses.replace(REGISTRY["min_plus"],
                                                       mul=torch.mul),
        "and_or copy": dataclasses.replace(REGISTRY["and_or"]),
        "plus_times without mxu": dataclasses.replace(REGISTRY["plus_times"],
                                                      mxu=False),
    }


@pytest.mark.parametrize("case", list(_off_registry()))
def test_off_registry_semiring_has_no_kernel(case):
    """A mxu=False semiring that is not the registry's own object raises
    ValueError naming the five ring semirings, before any launch; the CPU
    path still runs it through the plain versions."""
    sr = _off_registry()[case]
    with pytest.raises(ValueError, match="max_plus, min_plus, max_min, "
                       "max_times, and_or"):
        cuda_lib.kernel_semiring_id(sr)
    with pytest.raises(ValueError, match="max_plus, min_plus"):
        t_sm.route(sr)
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(1, 9, (5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.integers(1, 9, (7, 3)).astype(np.float32))
    assert torch.equal(t_sm.semiring_matmul(a, b, semiring=sr),
                       semiring_matmul_ref(a, b, semiring=sr))
