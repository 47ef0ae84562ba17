"""The fused pair-list reduce's work items on the CPU: each run cut into
chunks of at most ``REDUCE_CHUNK`` pairs (``reduce_chunks``, which the card
wrapper hands the kernels), a [128] partial per chunk, then the fold of
each output's partials in item order — done here in torch as the kernels
do it (``csrc/pairlist_items.cuh``), and held against the plain version
``bsr_pairlist_reduce_ref`` and the JAX package's reference, for every
semiring and both axes, with runs longer than a chunk and an empty run.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spgemm import ref as j_bsr_ref
from repro_torch.core import REGISTRY
from repro_torch.kernels.bsr_spgemm import ops as t_bsr
from repro_torch.kernels.bsr_spgemm import ref as t_bsr_ref

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import SEMIRINGS, assert_same


def item_range(runs, chunk_off, chunk, i):
    """Item i's output and pairs [p0, p1): the output o with chunk_off[o]
    <= i < chunk_off[o + 1] (the kernels' binary search), its chunk
    i - chunk_off[o]."""
    o = int(np.searchsorted(chunk_off, i, side="right")) - 1
    p0 = int(runs[o]) + (i - int(chunk_off[o])) * chunk
    return o, p0, min(p0 + chunk, int(runs[o + 1]))


def chunked_reduce(at, bt, pa, pb, po, n_o, axis, sr, chunk):
    """The kernels' fused reduce in torch: chunk partials, then the fold."""
    runs = t_bsr.run_offsets(po, n_o)
    chunk_off, max_items = t_bsr.reduce_chunks(runs, pa.shape[0], chunk)
    n_items = int(chunk_off[-1])
    assert n_items <= max_items
    part = torch.full((max_items, 128), sr.zero)
    for i in range(n_items):
        o, p0, p1 = item_range(runs.numpy(), chunk_off.numpy(), chunk, i)
        c = torch.full((128, 128), sr.zero)
        for p in range(p0, p1):
            c = sr.add(c, sr.matmul_dense(at[pa[p]], bt[pb[p]]))
        part[i] = sr.add_reduce(c, axis=axis)
    out = torch.empty((n_o, 128))
    for o in range(n_o):
        v = part[int(chunk_off[o])]
        for c in range(int(chunk_off[o]) + 1, int(chunk_off[o + 1])):
            v = sr.add(v, part[c])
        out[o] = v
    return out


def _case(rng, sr, lengths, n_a=4, n_b=5):
    """Tiles of small integers with a third of the entries at the semiring
    zero (every ⊕ exact in any order), and pairs for runs of the given
    lengths, sorted by output."""
    z = REGISTRY[sr].zero

    def tiles(n):
        v = rng.integers(1, 5, (n, 128, 128)).astype(np.float32)
        v[rng.random(v.shape) < 1 / 3] = z
        return v
    n = sum(lengths)
    pa = rng.integers(0, n_a, n).astype(np.int32)
    pb = rng.integers(0, n_b, n).astype(np.int32)
    po = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    return tiles(n_a), tiles(n_b), pa, pb, po


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sr", SEMIRINGS)
def test_chunked_reduce_equals_the_plain_version(sr, axis):
    """Runs of 9 (three chunks of 4), 0, 4 (one) and 5 (two) pairs."""
    rng = np.random.default_rng(31 + axis)
    a, b, pa, pb, po = _case(rng, sr, [9, 0, 4, 5])
    args = [torch.from_numpy(x) for x in (a, b, pa, pb, po)]
    got = chunked_reduce(*args, n_o=4, axis=axis, sr=REGISTRY[sr], chunk=4)
    want = t_bsr_ref.bsr_pairlist_reduce_ref(*args, n_o=4, axis=axis,
                                             semiring=sr)
    assert torch.equal(got, want)
    assert_same(got, j_bsr_ref.bsr_pairlist_reduce_ref(
        *[jnp.asarray(x) for x in (a, b, pa, pb, po)], n_o=4, axis=axis,
        semiring=sr), sr, floats=False)


@pytest.mark.parametrize("sr", ["plus_times", "min_plus"])
def test_chunked_reduce_at_the_kernels_chunk(sr):
    """The kernels' own chunk: a run of REDUCE_CHUNK + 1 pairs is two
    items."""
    rng = np.random.default_rng(33)
    n = t_bsr.REDUCE_CHUNK + 1
    a, b, pa, pb, po = _case(rng, sr, [n, 1])
    args = [torch.from_numpy(x) for x in (a, b, pa, pb, po)]
    runs = t_bsr.run_offsets(args[4], 2)
    assert t_bsr.reduce_chunks(runs, n + 1)[0].tolist() == [0, 2, 3]
    got = chunked_reduce(*args, n_o=2, axis=1, sr=REGISTRY[sr],
                         chunk=t_bsr.REDUCE_CHUNK)
    assert torch.equal(got, t_bsr_ref.bsr_pairlist_reduce_ref(
        *args, n_o=2, axis=1, semiring=sr))


@pytest.mark.parametrize("lengths,chunk,want", [
    ([0], 16, [0, 1]),                      # an empty run is one item
    ([16, 17, 32, 33], 16, [0, 1, 3, 5, 8]),
    ([95, 0, 1], 16, [0, 6, 7, 8]),         # the n=18 reduce's longest run
    ([3, 3, 3], 1, [0, 3, 6, 9]),
])
def test_reduce_chunks(lengths, chunk, want):
    """Chunk offsets per output, and the host's bound on the items:
    outputs + pairs // chunk, never below the count."""
    po = torch.from_numpy(np.repeat(np.arange(len(lengths)),
                                    lengths).astype(np.int32))
    runs = t_bsr.run_offsets(po, len(lengths))
    off, bound = t_bsr.reduce_chunks(runs, sum(lengths), chunk)
    assert off.dtype == torch.int32 and off.tolist() == want
    assert bound == len(lengths) + sum(lengths) // chunk >= want[-1]


@pytest.mark.parametrize("reduce", [False, True])
def test_wrappers_take_host_pair_lists(reduce):
    """The planner hands the pair lists over as host numpy arrays (the card
    route checks them there, with no read-back): both wrappers give the
    same result for them as for int32 tensors."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randint(1, 9, (3, 128, 128), generator=gen).float() / 4
    b = torch.randint(1, 9, (2, 128, 128), generator=gen).float() / 4
    pa = np.array([0, 2, 1, 1, 2], np.int64)
    pb = np.array([1, 0, 0, 1, 1], np.int64)
    px = np.array([0, 0, 1, 2, 2], np.int64)

    def run(*pairs):
        if reduce:
            return t_bsr.bsr_pairlist_reduce(a, b, *pairs, n_o=3, axis=0)
        return t_bsr.bsr_pairlist(a, b, *pairs, n_c=3)

    want = run(*(torch.from_numpy(p.astype(np.int32)) for p in (pa, pb, px)))
    np.testing.assert_array_equal(run(pa, pb, px).numpy(), want.numpy())
