"""Shared helpers of the ``test_torch_*`` files: seeded numpy inputs fed to
both the JAX package (``repro``) and its PyTorch port (``repro_torch``)."""
import numpy as np
import pytest
import torch

SEMIRINGS = ("plus_times", "max_plus", "min_plus", "max_min", "max_times",
             "and_or")

# exact comparisons everywhere except (+,×) sums of random floats, whose
# order differs between the packages: rtol 1e-5
RTOL_PLUS_TIMES = 1e-5


def keys(rng, n, k, width=4):
    """n zero-padded decimal keys drawn from k distinct values."""
    return np.char.zfill(rng.integers(0, k, n).astype(str), width)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, semiring="max_plus", floats=True):
    """Port result ``got`` against JAX result ``want``: exact, except
    rtol 1e-5 for (+,×) on random floats."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if semiring == "plus_times" and floats:
        np.testing.assert_allclose(g, w, rtol=RTOL_PLUS_TIMES, atol=1e-6)
    else:
        np.testing.assert_array_equal(g, w)


def assert_same_tensor(t, j, semiring="max_plus", floats=True):
    """A port AssocTensor against a JAX AssocTensor, field by field."""
    assert int(t.nnz) == int(j.nnz)
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(np_of(t.rows), np_of(j.rows))
    np.testing.assert_array_equal(np_of(t.cols), np_of(j.cols))
    assert_same(t.vals, j.vals, semiring, floats)
    np.testing.assert_array_equal(t.row_space.keys, j.row_space.keys)
    np.testing.assert_array_equal(t.col_space.keys, j.col_space.keys)


def assert_same_assoc(t, j):
    """A port host Assoc against a JAX host Assoc, triple by triple."""
    for x, y in zip(t.triples(), j.triples()):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(autouse=True)
def _reset_port_stats():
    """Every port test starts from zeroed port counters (the repo's
    conftest does the same for ``repro``)."""
    from repro_torch import core
    core.reset_all_stats()
    yield
