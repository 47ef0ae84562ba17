"""Module step 9f on the CPU: the port's checkpoints
(``repro_torch.checkpoint``) against the JAX package's
(``repro.checkpoint``), in the same on-disk format.

``tests/test_checkpoint.py``'s first four tests on the port (its elastic
re-sharding test has no counterpart until the port has a training mesh,
module step 10), and the format held to the JAX package's both ways: on a
tree of nested dicts, a list and a tuple with float32, bfloat16, int8, an
int32 scalar and an int8 moment ``{"q", "s"}``, the manifest and every
``.npy`` file the port writes equal the JAX package's byte for byte
(bfloat16 as ``'<V2'`` items under the manifest dtype ``"bfloat16"``),
and a checkpoint written by either package restores in the other bit for
bit.  Then what the port adds: a restore writes into the target's tensors
in place, and ``save_async``'s host copy is immune to the in-place update
that follows it (the port's AdamW updates parameters and moments in
place).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_checkpoint as j_restore_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.checkpoint.checkpoint import latest_step as j_latest_step
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import latest_step

from _torch_helpers import _reset_port_stats  # noqa: F401


def _state(seed=0):
    """The JAX package's test state, as torch tensors."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
                       "b": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))},
            "opt": {"m": {"w": torch.zeros((4, 3)), "b": torch.ones((3,))},
                    "count": torch.tensor(7, dtype=torch.int32)}}


def _mixed_np(seed=0):
    """Nested dict, list and tuple with float32, bfloat16 (as ml_dtypes),
    int8, an int32 scalar and a q8 moment, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"params": {"embed": {"table": f32(6, 5).astype(ml_dtypes.bfloat16)},
                       "layers": [{"w": f32(5, 5).astype(ml_dtypes.bfloat16),
                                   "g": f32(5)},
                                  {"w": f32(5, 5).astype(ml_dtypes.bfloat16),
                                   "g": f32(5)}]},
            "opt": ({"q": rng.integers(-127, 128, (5, 130)).astype(np.int8),
                     "s": np.abs(f32(5, 2))},
                    f32(5, 130),
                    np.int32(11)),
            "mask": rng.integers(-3, 4, (7,)).astype(np.int8)}


def _to_torch(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return _map(leaf, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _bits(x):
    """A leaf's raw bytes with its dtype's name and shape."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (str(t.dtype).split(".")[-1], tuple(t.shape),
                raw.numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _assert_bits_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _bits(a) == _bits(b)


def _files(path):
    base = os.path.join(path, "step_00000003")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {n: open(os.path.join(base, "arrays", n), "rb").read()
              for n in sorted(os.listdir(os.path.join(base, "arrays")))}
    return manifest, arrays


def test_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 42, s, extra={"pipeline": {"step": 9}})
    restored, step, extra = restore_checkpoint(str(tmp_path), _state(seed=99))
    assert step == 42 and extra["pipeline"]["step"] == 9
    _assert_bits_equal(restored, s)


def test_format_equals_jax_byte_for_byte(tmp_path):
    """The same tree saved by both packages: the same manifest (keys in
    the JAX flattening order, shapes, dtype names) and the same bytes in
    every ``.npy`` file."""
    tree = _mixed_np()
    j_save_checkpoint(str(tmp_path / "jax"), 3,
                      jax.tree.map(jnp.asarray, tree), extra={"k": 1})
    save_checkpoint(str(tmp_path / "port"), 3, _to_torch(tree),
                    extra={"k": 1})
    jm, ja = _files(str(tmp_path / "jax"))
    pm, pa = _files(str(tmp_path / "port"))
    assert pm == jm
    assert {m["dtype"] for m in pm["leaves"]} == {
        "float32", "bfloat16", "int8", "int32"}
    assert "opt/0/q" in {m["key"] for m in pm["leaves"]}
    assert pa.keys() == ja.keys()
    for name in pa:
        assert pa[name] == ja[name], name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_restore(tmp_path, writer):
    """A checkpoint written by either package restores in the other (and
    in itself), bit for bit, bfloat16 included."""
    tree = _mixed_np(seed=1)
    if writer == "jax":
        j_save_checkpoint(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    else:
        save_checkpoint(str(tmp_path), 3, _to_torch(tree))
    zeros = _mixed_np(seed=2)
    got, step, _ = restore_checkpoint(str(tmp_path), _to_torch(zeros))
    assert step == 3
    _assert_bits_equal(got, _to_torch(tree))
    jgot, jstep, _ = j_restore_checkpoint(str(tmp_path),
                                          jax.tree.map(jnp.asarray, zeros))
    assert jstep == 3
    assert jgot["params"]["embed"]["table"].dtype == jnp.bfloat16
    _assert_bits_equal(jax.tree.map(np.asarray, jgot), tree)


def test_restore_writes_in_place_and_to_a_device(tmp_path):
    tree = _to_torch(_mixed_np(seed=3))
    save_checkpoint(str(tmp_path), 3, tree)
    target = _to_torch(_mixed_np(seed=4))
    leaves = _leaves(target)
    got, _, _ = restore_checkpoint(str(tmp_path), target)
    assert all(a is b for a, b in zip(_leaves(got), leaves))
    _assert_bits_equal(target, tree)
    # device=: new tensors there, the target only gives structure/shapes
    template = _mixed_np(seed=5)
    got, _, _ = restore_checkpoint(str(tmp_path), template, device="cpu")
    _assert_bits_equal(got, tree)
    assert all(isinstance(x, torch.Tensor) for x in _leaves(got))


def test_crash_safety_tmp_not_visible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    # simulate a crashed half-write
    os.makedirs(tmp_path / "step_00000002.tmp" / "arrays", exist_ok=True)
    assert latest_step(str(tmp_path)) == j_latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "absent")) is None


def test_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2,
                            save_interval_steps=5)
    jmgr = JCheckpointManager(str(tmp_path / "jax"), keep=2,
                              save_interval_steps=5)
    s = _state()
    for step in (5, 10, 15):
        assert mgr.should_save(step) == jmgr.should_save(step) is True
        mgr.save_async(step, s, extra={"step": step})
        jmgr.save_async(step, jax.tree.map(jnp.asarray, _leafwise_np(s)),
                        extra={"step": step})
        assert mgr.should_save(step) == jmgr.should_save(step) is False
    mgr.wait()
    jmgr.wait()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == \
        ["step_00000010", "step_00000015"]  # keep=2
    restored, step, extra = mgr.restore_latest(_state(1))
    assert step == 15 and extra["step"] == 15
    _assert_bits_equal(restored, s)
    assert [r["step"] for r in mgr.saves] == [5, 10, 15]
    assert all(r["bytes"] == 4 * (12 + 3 + 12 + 3 + 1) and "write_s" in r
               for r in mgr.saves)
    assert len(mgr.restores) == 1


def _leafwise_np(tree):
    return _map(lambda t: t.numpy(), tree)


def test_save_async_is_safe_against_in_place_updates(tmp_path):
    """The train step updates parameters and moments in place right after
    a save: the checkpoint holds the values of the moment of the save."""
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    s = _state()
    want = _map(lambda t: t.clone(), s)
    mgr.save_async(1, s)
    for t in _leaves(s):          # the next step, before the writer ends
        t.add_(1)
    mgr.wait()
    got, _, _ = restore_checkpoint(str(tmp_path), _state(seed=5))
    _assert_bits_equal(got, want)


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((3,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):          # in place: dtypes must agree
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((3,),
                                                            dtype=torch.int32)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"v": torch.zeros((3,))})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), {"w": torch.zeros((3,))})
