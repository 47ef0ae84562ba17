"""Module step 9f on the CPU: the port's gradient compression
(``repro_torch.distributed.compression``) against the JAX package's.

``tests/test_compression.py``'s two tests on the port (the round trip
within one quantization step of the leaf's largest value; error feedback
keeping the sum of what was sent within the carried residual of the sum
of the true gradients over 50 rounds), and the port held to the JAX
package over three error-feedback rounds on the same seeded gradient
trees (nested dict and list; a leaf whose last axis is no multiple of the
128-element block; a bfloat16 leaf; a scalar): ``q`` equal, ``s``, the
error state and the decompressed tree within float32 rounding (rtol 1e-6
of each leaf's largest value: the two packages divide and round the same
float32 values, and the error state is the difference of two of them).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.distributed import compress_tree as j_compress_tree
from repro.distributed import decompress_tree as j_decompress_tree
from repro_torch.distributed import compress_tree, decompress_tree

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401

FP32_RTOL = 1e-6
ROUNDS = 3


def test_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))}
    comp, err = compress_tree(g)
    assert comp["w"]["q"].dtype == torch.int8 and comp["w"]["q"].shape == (300,)
    assert comp["w"]["s"].shape == (3,)
    deq = decompress_tree(comp, g)
    scale = float(g["w"].abs().max())
    assert float((deq["w"] - g["w"]).abs().max()) <= scale / 127 + 1e-6
    torch.testing.assert_close(err["w"], g["w"] - deq["w"], rtol=0, atol=0)


def test_error_feedback_unbiased_accumulation():
    """Σ dequantized ≈ Σ true gradients when errors are carried forward."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64)
    deq_sum = np.zeros(64)
    err = None
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        comp, err = compress_tree(g, err)
        deq = decompress_tree(comp, g)
        true_sum += g["w"].numpy()
        deq_sum += deq["w"].numpy()
    # residual carried in `err` is bounded → sums track each other
    resid = float(err["w"].abs().max())
    np.testing.assert_allclose(deq_sum, true_sum, atol=resid + 1e-4)


def _grads(rng):
    """One round's gradient tree as numpy (bfloat16 through ml_dtypes)."""
    return {"embed": rng.normal(size=(6, 256)).astype(np.float32) * 3,
            "layers": [{"w": rng.normal(size=(5, 300)).astype(np.float32),
                        "b": (rng.normal(size=(130,)) * 1e-3).astype(
                            ml_dtypes.bfloat16)},
                       {"w": rng.normal(size=(2, 3, 40)).astype(np.float32),
                        "b": np.float32(rng.normal()).reshape(())}]}


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _close(got, want, name):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_RTOL * float(
        np.abs(want).max()) + 1e-30, err_msg=name)


def test_matches_jax_over_error_feedback_rounds():
    rng = np.random.default_rng(2)
    err = j_err = None
    for r in range(ROUNDS):
        g_np = _grads(rng)
        g = jax.tree.map(_torch, g_np)
        j_g = jax.tree.map(jnp.asarray, g_np)
        comp, err = compress_tree(g, err)
        j_comp, j_err = j_compress_tree(j_g, j_err)
        deq = decompress_tree(comp, g)
        j_deq = j_decompress_tree(j_comp, j_g)
        flat = jax.tree_util.tree_flatten_with_path(j_comp)[0]
        assert len(flat) == 2 * len(jax.tree.leaves(j_g))
        for path, want in flat:
            got = comp
            for key in path:
                got = got[getattr(key, "key", getattr(key, "idx", None))]
            name = f"round {r} {jax.tree_util.keystr(path)}"
            if path[-1].key == "q":
                assert got.dtype == torch.int8, name
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=name)
            else:
                _close(got, want, name)
        for tree, j_tree, what in ((err, j_err, "error"), (deq, j_deq, "deq")):
            for path, want in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
                got = tree
                for key in path:
                    got = got[getattr(key, "key", getattr(key, "idx", None))]
                assert got.dtype == torch.float32
                _close(got, want, f"round {r} {what} "
                       f"{jax.tree_util.keystr(path)}")
