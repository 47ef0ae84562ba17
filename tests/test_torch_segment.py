"""The segmented scan (``segment_scan``/``aggregate_runs``): the port's
plain version against the JAX package's oracle and its Pallas kernel in
interpret mode, for the three combines, on sizes that are not multiples of
256 and with runs that cross the Pallas kernel's 256- and 1024-element
block boundaries.

``min``/``max`` agree exactly; ``sum`` is taken in another order by each
version, so sums agree to 1e-5.  The CUDA kernel runs in
``test_torch_cuda.py`` on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import ops as j_ops
from repro.kernels.segment_reduce.ref import segment_scan_ref
from repro_torch.kernels.segment_reduce import ops as t_ops
from repro_torch.kernels.segment_reduce.ref import segment_scan_ref as t_ref

from _torch_helpers import _reset_port_stats  # noqa: F401

COMBINES = ("sum", "min", "max")
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


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("n,max_run", [(1, 1), (255, 40), (1000, 600),
                                       (2100, 300), (3000, 900)])
def test_segment_scan_matches_jax(n, max_run, combine):
    keys, vals = runs_input(n, n, max_run)
    got = t_ops.segment_scan(torch.from_numpy(keys), torch.from_numpy(vals),
                             combine=combine).numpy()
    assert_scan(got, j_ref(jnp.asarray(keys), jnp.asarray(vals),
                           combine=combine), combine)
    # the Pallas kernel (interpret mode) takes a padded size that is at
    # most 1024 or a multiple of 1024 (its wrapper asserts so at 2100)
    if -(-n // 256) * 256 <= 1024 or -(-n // 256) % 4 == 0:
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
