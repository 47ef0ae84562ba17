"""Sharding hints usable from mesh-agnostic model code.

Nothing here is pjit: the name is the JAX package's
(``repro/models/pjit_utils.py``), kept so that a reader finds the
counterpart.  There, each helper is a ``with_sharding_constraint`` that
XLA's SPMD partitioner honours; here each is ``x.redistribute(mesh,
placements)`` on a DTensor, which issues the collectives at once.  The
most important is ``constrain_batch``: it pins the leading (batch) dim of
an activation to the data-parallel mesh dims and every other dim to
replication, so a row-parallel matmul's partial sums are all-reduced and
the residual stream stays batch-sharded.

A helper acts only while a mesh is active (:func:`use_mesh`, which the
step builder ``launch.steps.build_sharded`` enters; the counterpart of
``jax.set_mesh``) and only on a DTensor.  Otherwise it returns ``x``: one
card, the CPU tests, every unsharded step.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional, Tuple

_MESH = None
_BATCH_OVER_MODEL = False  # fsdp_only parallelism: model dim joins DP


@contextlib.contextmanager
def use_mesh(mesh, parallelism: Optional[str] = None):
    """Make ``mesh`` (a DeviceMesh) the active mesh inside the block, and
    with ``parallelism`` given, set it for the block too.  Inside, a plain
    tensor meeting a DTensor counts as replicated (positions, masks, rope
    tables: DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _MESH, _BATCH_OVER_MODEL
    before = (_MESH, _BATCH_OVER_MODEL)
    _MESH = mesh
    if parallelism is not None:
        set_parallelism(parallelism)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH, _BATCH_OVER_MODEL = before


def set_parallelism(mode: str):
    """``"fsdp_only"`` folds the model dim into the batch dims."""
    global _BATCH_OVER_MODEL
    _BATCH_OVER_MODEL = (mode == "fsdp_only")


def _current_axis_names() -> Tuple[str, ...]:
    return tuple(_MESH.mesh_dim_names) if _MESH is not None else ()


def _size(name: str) -> int:
    return _MESH.size(_MESH.mesh_dim_names.index(name))


def _axes_size(axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= _size(a)
    return n


def batch_axes_in_mesh() -> Optional[Tuple[str, ...]]:
    names = _current_axis_names()
    pool = ("pod", "data", "model") if _BATCH_OVER_MODEL else ("pod", "data")
    axes = tuple(a for a in pool if a in names)
    return axes or None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, read off ``sys.modules``: no DTensor
    exists before ``torch.distributed.tensor`` is imported, which one-card
    code never does, so its hot paths pay neither the import nor a call."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def whole(t):
    """A DTensor as its whole tensor, and a ``LocalTensor`` (the ranks
    that ``LocalTensorMode`` simulates) as one plain tensor, which the
    ranks' copies must all equal (``reconcile`` raises otherwise);
    anything else as it is."""
    if is_dtensor(t):
        t = t.full_tensor()
    mod = sys.modules.get("torch.distributed._local_tensor")
    if mod is not None and isinstance(t, mod.LocalTensor):
        t = t.reconcile()
    return t


def constrain(x, *spec_entries):
    """``x`` redistributed to the spec ``P(*spec_entries)`` if a mesh is
    active and ``x`` is a DTensor, else ``x``."""
    if not _current_axis_names() or not is_dtensor(x):
        return x
    from repro_torch.launch.sharding import P, placements
    target = placements(P(*spec_entries), _MESH)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(_MESH, target)


def constrain_batch(x, n_extra: Optional[int] = None, *, dim: int = 0):
    """Pin dim ``dim`` (0: the batch) to the batch dims; remaining dims
    replicated."""
    axes = batch_axes_in_mesh()
    if axes is None or not is_dtensor(x):
        return x
    extra = x.ndim - 1 if n_extra is None else n_extra
    if x.shape[dim] % _axes_size(axes):
        return x
    spec = [None] * (extra + 1)
    spec[dim] = axes
    return constrain(x, *spec)


def constrain_seq(x):
    """Megatron-style sequence parallelism: the residual stream lives
    S-sharded over `model` between blocks."""
    names = _current_axis_names()
    if "model" not in names or not is_dtensor(x) or x.ndim < 3:
        return x
    if x.shape[1] % _size("model"):
        return x
    b_axes = batch_axes_in_mesh()
    b = b_axes if (b_axes and x.shape[0] % _axes_size(b_axes) == 0) else None
    return constrain(x, b, "model", *([None] * (x.ndim - 2)))


def constrain_decode_qkv(q, k, v, n_kv_heads: int):
    """dh-shard decode q/k/v when kv heads can't shard over `model`."""
    names = _current_axis_names()
    if "model" not in names:
        return q, k, v
    if n_kv_heads % _size("model") == 0:
        return q, k, v  # kv-head sharding is consistent; leave it alone
    return (constrain_last_model(q), constrain_last_model(k),
            constrain_last_model(v))


def constrain_last_model(x):
    """Shard the LAST dim over `model` (if present & divisible), batch on
    0: decode's q/k/v then contract a model-sharded head dim against the
    head-dim-sharded cache (``launch.sharding.cache_specs``) instead of
    gathering the cache."""
    names = _current_axis_names()
    if "model" not in names or not is_dtensor(x):
        return x
    if x.shape[-1] % _size("model"):
        return x
    b_axes = batch_axes_in_mesh()
    b = b_axes if (b_axes and x.shape[0] % _axes_size(b_axes) == 0) else None
    return constrain(x, b, *([None] * (x.ndim - 2)), "model")


def constrain_heads(x, n_heads: int):
    """A [..., n_heads·dh] activation whose last dim shards over `model`
    gathered over `model` when ``n_heads`` does not divide it, so the
    split into heads never cuts a head (batch kept on dim 0)."""
    names = _current_axis_names()
    if "model" not in names or not is_dtensor(x) \
            or n_heads % _size("model") == 0:
        return x
    return constrain_batch(x)


def gather_dim(x, dim: int):
    """A DTensor with no mesh dim sharding tensor dim ``dim`` (those mesh
    dims replicated, the rest as they were); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.ndim
    target = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim
                   else pl for pl in x.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def fsdp_gather(w):
    """A parameter as a matmul or an elementwise op takes it: a DTensor
    replicated over the active mesh's batch dims (pod/data, and model under
    fsdp_only; without an active mesh, pod and data), its tensor-parallel
    shards kept (FSDP's per-layer all-gather; its backward reduce-scatters
    the gradient).  Anything else as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = tuple(w.device_mesh.mesh_dim_names)
    axes = batch_axes_in_mesh() if _MESH is not None else \
        tuple(a for a in ("pod", "data") if a in names)
    target = tuple(Replicate() if names[m] in (axes or ()) else pl
                   for m, pl in enumerate(w.placements))
    if target == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)
