"""Checkpointing: async host-side writes, manifest-driven restore (the JAX
package's ``repro.checkpoint`` on torch tensors, in the same format).

Design:
* **Step path never blocks on disk.**  ``save_async()`` copies every leaf
  to host memory, then a background thread serializes.  The train loop
  keeps stepping; ``wait()`` joins before the next save or at shutdown.
* **The host copy is synchronous.**  The port's train step updates the
  parameters and AdamW moments in place (``optim.adamw_update``), so a
  copy still in flight when the next step starts would save a mix of two
  steps.  ``save_async`` copies each card leaf into pinned host memory
  (``non_blocking``, one launch a leaf) and synchronizes before it
  returns: the caller pays one device-to-host read of the whole state
  (for qwen3-1.7b with fp32 moments, 17.2 GB; ``chip_smoke.py``'s
  ``[train launch]`` lines time it) and holds that much pinned host
  memory until the writer is done.  The pinned blocks go back to
  PyTorch's host allocator when the writer drops them, and the next save
  takes them again: ``save_async`` waits for the writer before it
  copies.
* **Manifest-driven layout**, the JAX package's on disk, so that either
  package restores the other's checkpoints::

      <dir>/step_XXXXXXXX/arrays/NNNNN.npy     one per leaf, in key order
      <dir>/step_XXXXXXXX/manifest.json        {"step", "extra", "leaves":
                                                [{"key", "file", "shape",
                                                  "dtype"}, ...]}

  A leaf's key is its path: dict keys (in sorted order, as
  ``jax.tree_util`` flattens a dict) and list or tuple indices joined by
  ``/``; ``None`` is an empty subtree.  An int8 moment ``{"q", "s"}`` is
  a dict of two leaves.
* **bfloat16 without ml_dtypes.**  numpy has no bfloat16; the JAX package
  saves ml_dtypes' bfloat16, whose ``.npy`` header reads ``'<V2'`` (raw
  2-byte items), under the manifest dtype ``"bfloat16"``.  The port writes
  the leaf's bits (``t.view(torch.int16)``) under the same header and
  dtype, and reads them back by ``view``: no pass through float32 (twice
  the bytes) or uint16 (which the JAX restore would convert by value).
* **Atomicity / crash-safety.**  Writes go to ``<dir>.tmp`` then
  ``os.replace`` to the final name; a half-written checkpoint is never
  visible.  ``latest_step`` scans only committed manifests; restart after
  a failure (``repro_torch.distributed.fault_tolerance``) always lands on
  a complete checkpoint.
* **Restore in place.**  ``restore_checkpoint`` overwrites every tensor
  leaf of the target on the target's own device, a leaf a failed step
  may have half-updated included.
* **Elastic restore.**  Leaves are stored as GLOBAL arrays: a DTensor
  leaf is saved whole (``full_tensor``), as the JAX package saves a
  sharded array.  ``restore_checkpoint(..., shardings=(specs, mesh))``
  re-shards each leaf onto the current DeviceMesh: every rank reads only
  its own block of the memory-mapped ``.npy`` and wraps it with
  ``DTensor.from_local``, so any mesh whose dims divide the leaves
  restores a checkpoint written under any other (or none).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.pjit_utils import whole

BF16 = "bfloat16"     # its manifest dtype
BF16_DESCR = "<V2"   # its .npy header's descr (ml_dtypes' bfloat16)


def _is_spec(t) -> bool:
    from repro_torch.launch.sharding import P
    return isinstance(t, P)


def _flatten_with_paths(tree, prefix: Tuple = (),
                        is_leaf=None) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [("/".join(str(p) for p in prefix), tree)]
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    return [kv for k, v in items
            for kv in _flatten_with_paths(v, prefix + (k,), is_leaf)]


def _unflatten(tree, leaves):
    """``tree``'s structure with the leaves of ``leaves`` (an iterator, in
    :func:`_flatten_with_paths` order) in place of its own."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf):
    """A host copy of ``leaf`` that no later in-place update can reach (a
    CPU tensor is cloned too).  A card leaf's copy is asynchronous, into
    pinned memory: synchronize before reading it."""
    leaf = whole(leaf)
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            return out.copy_(leaf.detach(), non_blocking=True)
        return leaf.detach().clone()
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """``leaf`` as the array written to disk and its manifest dtype."""
    leaf = whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        arr.tofile(f)


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded (C-contiguous, writable) array as a tensor of the manifest's
    dtype."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    dt = np.dtype(dtype)
    if arr.dtype != dt:
        arr = (arr.view(dt) if arr.dtype.kind == "V"
               and arr.dtype.itemsize == dt.itemsize else arr.astype(dt))
    return torch.from_numpy(arr)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    return _as_tensor(np.load(path), dtype)


def _read_sharded(path: str, dtype: str, spec, mesh, device):
    """The DTensor of one leaf placed by ``spec`` on ``mesh``: each rank
    reads its own block of the memory-mapped array."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as shd
    arr = np.load(path, mmap_mode="r")
    local = shd.per_rank(mesh, lambda c: _as_tensor(
        np.array(arr[shd.block_slices(arr.shape, spec, mesh, c)]),
        dtype).to(device))
    return DTensor.from_local(local, mesh, shd.placements(spec, mesh),
                              run_check=False, shape=torch.Size(arr.shape),
                              stride=torch.empty(arr.shape,
                                                 device="meta").stride())


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    *, extra: Optional[Dict] = None) -> str:
    """Synchronous core writer (the async manager wraps this).  Leaves may
    be tensors on any device, numpy arrays or numbers."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir, exist_ok=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(state)):
        arr, dtype = _to_numpy(leaf)
        fname = f"{i:05d}.npy"
        _write_leaf(os.path.join(arrays_dir, fname), arr, dtype)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, target_state: Dict[str, Any],
                       *, step: Optional[int] = None, device=None,
                       shardings=None):
    """Restore into the structure of ``target_state`` → ``(state, step,
    extra)``.

    With ``device=None`` each tensor leaf of the target is overwritten in
    place on its own device (its dtype must be the checkpoint's), and each
    other leaf (a numpy array or a number) becomes a CPU tensor; with a
    ``device``, every leaf becomes a new tensor there and the target gives
    only the structure and the shapes.  ``shardings=(specs, mesh)``: a tree
    of partition specs (``launch.sharding.P``, the target's structure) and
    their DeviceMesh; every leaf becomes a DTensor placed by its spec,
    each rank's block read from the memory-mapped array onto ``device``
    (default: the mesh's device type).  A key the checkpoint lacks raises
    ``KeyError``, a shape that differs ``ValueError``.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    by_key = {m["key"]: m for m in manifest["leaves"]}
    specs = mesh = None
    if shardings is not None:
        spec_tree, mesh = shardings
        specs = dict(_flatten_with_paths(spec_tree, is_leaf=_is_spec))
        device = device or mesh.device_type
    new_leaves = []
    for key, leaf in _flatten_with_paths(target_state):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        path = os.path.join(base, "arrays", meta["file"])
        if tuple(meta["shape"]) != tuple(np.shape(leaf)):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(meta['shape'])} vs "
                f"target {tuple(np.shape(leaf))}")
        if specs is not None:
            new_leaves.append(_read_sharded(path, meta["dtype"], specs[key],
                                            mesh, device))
            continue
        src = _read_leaf(path, meta["dtype"])
        if device is None and isinstance(leaf, torch.Tensor):
            if leaf.dtype != src.dtype:
                raise ValueError(f"dtype mismatch for {key}: ckpt "
                                 f"{src.dtype} vs target {leaf.dtype}")
            with torch.no_grad():
                leaf.copy_(src)
            new_leaves.append(leaf)
        else:
            new_leaves.append(src.to(device or "cpu"))
    state = _unflatten(target_state, iter(new_leaves))
    return state, step, manifest["extra"]


class CheckpointManager:
    """Async manager: non-blocking saves, bounded retention, crash-safe.

    ``saves`` holds one record a save: its ``step``, ``bytes``, the
    synchronous host copy's seconds (``copy_s``) and the writer thread's
    (``write_s``, set when it finishes); ``restores`` the seconds of each
    ``restore_latest``."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 save_interval_steps: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.interval = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._last_saved: Optional[int] = None
        self.saves: List[Dict[str, Any]] = []
        self.restores: List[float] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step % self.interval == 0 and step != (self._last_saved or -1)

    def save_async(self, step: int, state: Dict, *, extra=None):
        self.wait()
        # device→host copy happens HERE (synchronous) so the caller may
        # update device buffers in place immediately afterwards
        t0 = time.perf_counter()
        host_state = _unflatten(state, iter(
            _to_host(leaf) for _, leaf in _flatten_with_paths(state)))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        record = {"step": step, "copy_s": time.perf_counter() - t0,
                  "bytes": sum(x.nbytes for _, x in
                               _flatten_with_paths(host_state)
                               if isinstance(x, (torch.Tensor, np.ndarray)))}
        self.saves.append(record)

        def _work():
            t1 = time.perf_counter()
            save_checkpoint(self.dir, step, host_state, extra=extra)
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()
        self._last_saved = step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target_state, *, device=None):
        self.wait()  # an in-flight async save must land before we look
        t0 = time.perf_counter()
        out = restore_checkpoint(self.dir, target_state, device=device)
        self.restores.append(time.perf_counter() - t0)
        return out
