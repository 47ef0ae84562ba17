"""Each ported kernel's plain torch version against the JAX package: its
``ref.py`` oracle AND its Pallas body run in interpret mode, under every
semiring, plus the port's dispatch rules.

The CUDA kernels themselves need a card: ``test_torch_cuda.py`` holds them
against these plain versions there (``chip_smoke.py`` does too, at the main
path's shapes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import ops as j_bsr
from repro.kernels.bsr_spgemm import ref as j_bsr_ref
from repro.kernels.range_extract import ops as j_rm
from repro.kernels.range_extract.ref import range_mask_ref as j_rm_ref
from repro.kernels.semiring_matmul import ops as j_sm
from repro.kernels.semiring_matmul.ref import semiring_matmul_ref as j_sm_ref
from repro_torch.core import REGISTRY
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spgemm import ops as t_bsr
from repro_torch.kernels.bsr_spgemm import ref as t_bsr_ref
from repro_torch.kernels.range_extract import ops as t_rm
from repro_torch.kernels.range_extract.ref import range_mask_ref as t_rm_ref
from repro_torch.kernels.semiring_matmul import ops as t_sm
from repro_torch.kernels.semiring_matmul.ref import semiring_matmul_ref as t_sm_ref

from _torch_helpers import SEMIRINGS, _reset_port_stats, assert_same  # noqa: F401

SENT = 2 ** 31 - 1


def _values(rng, shape, sr, floats):
    """Random operands: positive floats (sums without cancellation, so a
    relative tolerance is meaningful), or small integers (exact under every
    ⊕); about a third of the entries hold the semiring zero."""
    v = (rng.uniform(0.5, 1.5, shape) if floats
         else rng.integers(1, 5, shape)).astype(np.float32)
    v[rng.random(shape) < 0.35] = REGISTRY[sr].zero
    return v


# -- range_mask --------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 2051])
def test_range_mask_ref_matches(n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 60, n).astype(np.int32)
    cols = rng.integers(0, 60, n).astype(np.int32)
    rows[rng.random(n) < 0.1] = SENT
    for b in [(0, 60, 0, 60), (5, 40, 10, 30), (30, 30, 0, 60), (0, 60, 59, 60)]:
        got = t_rm_ref(torch.from_numpy(rows), torch.from_numpy(cols), b)
        jb = jnp.asarray(b, jnp.int32)
        want = j_rm_ref(jnp.asarray(rows), jnp.asarray(cols), jb)
        body = j_rm.range_mask(jnp.asarray(rows), jnp.asarray(cols), jb,
                               impl="interpret")
        assert_same(got, want)
        assert_same(got, body)
        # the dispatch takes the plain version for CPU tensors, and bounds
        # as a tensor of any shape
        assert_same(t_rm.range_mask(torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.tensor([b], dtype=torch.int32)),
                    want)


# -- semiring_matmul ---------------------------------------------------------------

@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("shape", [(32, 48, 16), (130, 70, 150)])
def test_semiring_matmul_ref_matches(sr, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    floats = sr == "plus_times"
    a = _values(rng, (m, k), sr, floats)
    b = _values(rng, (k, n), sr, floats)
    got = t_sm_ref(torch.from_numpy(a), torch.from_numpy(b), semiring=sr)
    assert_same(got, j_sm_ref(jnp.asarray(a), jnp.asarray(b), semiring=sr),
                sr)
    assert_same(got, j_sm.semiring_matmul(jnp.asarray(a), jnp.asarray(b),
                                          semiring=sr, impl="interpret"), sr)
    assert_same(t_sm.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                     semiring=sr), got, sr)


@pytest.mark.parametrize("sr", ["max_plus", "min_plus"])
def test_semiring_matmul_pad_keeps_result(sr):
    """The kernel path pads with the semiring zero to (128, 32, 128)
    multiples; padding a plain product the same way changes nothing."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_values(rng, (40, 33), sr, False))
    b = torch.from_numpy(_values(rng, (33, 50), sr, False))
    z = REGISTRY[sr].zero
    ap = t_sm._pad_to(a, t_sm.BM, t_sm.BK, z)
    bp = t_sm._pad_to(b, t_sm.BK, t_sm.BN, z)
    assert ap.shape == (128, 64) and bp.shape == (64, 128)
    assert_same(t_sm_ref(ap, bp, semiring=sr)[:40, :50],
                t_sm_ref(a, b, semiring=sr), sr)


# -- pair-list kernels ---------------------------------------------------------------

def _pairlist_case(rng, sr, floats, n_a=2, n_b=3, n_pairs=5):
    a = _values(rng, (n_a, 128, 128), sr, floats)
    b = _values(rng, (n_b, 128, 128), sr, floats)
    pa = rng.integers(0, n_a, n_pairs).astype(np.int32)
    pb = rng.integers(0, n_b, n_pairs).astype(np.int32)
    pc = np.sort(rng.integers(0, 3, n_pairs)).astype(np.int32)
    pc = np.searchsorted(np.unique(pc), pc).astype(np.int32)  # cover 0..n-1
    return a, b, pa, pb, pc, int(pc.max()) + 1


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_ref_matches(sr):
    rng = np.random.default_rng(11)
    a, b, pa, pb, pc, n_c = _pairlist_case(rng, sr, sr == "plus_times")
    t_args = [torch.from_numpy(x) for x in (a, b, pa, pb, pc)]
    j_args = [jnp.asarray(x) for x in (a, b, pa, pb, pc)]
    got = t_bsr_ref.bsr_pairlist_ref(*t_args, n_c=n_c, semiring=sr)
    assert_same(got, j_bsr_ref.bsr_pairlist_ref(*j_args, n_c=n_c,
                                                semiring=sr), sr)
    assert_same(got, j_bsr.bsr_pairlist(*j_args, n_c=n_c, semiring=sr,
                                        impl="interpret"), sr)
    assert_same(t_bsr.bsr_pairlist(*t_args, n_c=n_c, semiring=sr), got, sr)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_pairlist_reduce_ref_matches(sr, axis):
    rng = np.random.default_rng(12 + axis)
    a, b, pa, pb, po, n_o = _pairlist_case(rng, sr, sr == "plus_times")
    t_args = [torch.from_numpy(x) for x in (a, b, pa, pb, po)]
    j_args = [jnp.asarray(x) for x in (a, b, pa, pb, po)]
    got = t_bsr_ref.bsr_pairlist_reduce_ref(*t_args, n_o=n_o, axis=axis,
                                            semiring=sr)
    assert got.shape == (n_o, 128)
    assert_same(got, j_bsr_ref.bsr_pairlist_reduce_ref(
        *j_args, n_o=n_o, axis=axis, semiring=sr), sr)
    assert_same(got, j_bsr.bsr_pairlist_reduce(
        *j_args, n_o=n_o, axis=axis, semiring=sr, impl="interpret"), sr)
    assert_same(t_bsr.bsr_pairlist_reduce(*t_args, n_o=n_o, axis=axis,
                                          semiring=sr), got, sr)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_bsr_spgemm_reduce_ref_matches(sr, axis):
    rng = np.random.default_rng(21 + axis)
    floats = sr == "plus_times"
    a = _values(rng, (256, 256), sr, floats)
    b = _values(rng, (256, 128), sr, floats)
    mask = np.array([[1, 0], [1, 1]], np.int32)
    got = t_bsr_ref.bsr_spgemm_reduce_ref(
        torch.from_numpy(a), torch.from_numpy(mask), torch.from_numpy(b),
        axis=axis, semiring=sr)
    ja, jm, jb = jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b)
    assert_same(got, j_bsr_ref.bsr_spgemm_reduce_ref(ja, jm, jb, axis=axis,
                                                     semiring=sr), sr)
    assert_same(got, j_bsr.bsr_spgemm_reduce(ja, jm, jb, axis=axis,
                                             semiring=sr, impl="interpret"),
                sr)
    assert_same(t_bsr.bsr_spgemm_reduce(
        torch.from_numpy(a), torch.from_numpy(mask), torch.from_numpy(b),
        axis=axis, semiring=sr), got, sr)


def test_make_block_mask_matches():
    rng = np.random.default_rng(31)
    rows = rng.integers(0, 300, 50).astype(np.int32)
    cols = rng.integers(0, 260, 50).astype(np.int32)
    valid = rng.random(50) < 0.8
    rows[~valid] = SENT
    got = t_bsr.make_block_mask(torch.from_numpy(rows), torch.from_numpy(cols),
                                torch.from_numpy(valid), 3, 3)
    want = j_bsr.make_block_mask(jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(valid), 3, 3)
    assert_same(got, want)


def test_run_offsets():
    pc = torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32)
    assert t_bsr.run_offsets(pc, 4).tolist() == [0, 2, 3, 3, 6]


# -- dispatch rules ------------------------------------------------------------------

def test_dispatch_follows_device_and_never_falls_back():
    rows = torch.zeros(8, dtype=torch.int32)
    assert cuda_lib.resolve_impl("auto", rows) == "ref"
    assert cuda_lib.resolve_impl("cuda", rows) == "cuda"
    with pytest.raises(ValueError, match="impl"):
        cuda_lib.resolve_impl("pallas", rows)
    # a CPU tensor handed to the kernel raises; it is not run on the plain
    # version instead
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_rm.range_mask(rows, rows, (0, 1, 0, 1), impl="cuda")
    a = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_sm.semiring_matmul(a, a, impl="cuda")
    tiles = torch.zeros((1, 128, 128))
    p = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_pairlist(tiles, tiles, p, p, p, n_c=1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_bsr.bsr_pairlist_reduce(tiles, tiles, p, p, p, n_o=1, axis=1,
                                  impl="cuda")
    # the dense-strategy fused reduce has no kernel yet: it raises for the
    # card instead of running the materializing plain version there
    with pytest.raises(NotImplementedError, match="bsr_spgemm_reduce"):
        t_bsr.bsr_spgemm_reduce(a, torch.ones((1, 1), dtype=torch.int32), a,
                                axis=1, impl="cuda")
    assert all(v == 0 for v in LAUNCHES.values())


def test_kernel_sources_present_and_hashed():
    """Every source the build compiles is in the package, and the library
    name follows the sources (an edit forces a rebuild)."""
    for name in cuda_lib.SOURCES + cuda_lib.HEADERS:
        assert (cuda_lib._CSRC / name).is_file(), name
    assert len(cuda_lib._digest()) == 16
    assert set(cuda_lib.SEMIRING_IDS) == set(SEMIRINGS)
