"""Logical-axis → mesh-dim translation (TP / FSDP / EP rules), and the
DTensor placements of the result.

Every parameter carries logical axis names (:func:`repro_torch.models.
logical.param_logical`); this module turns them into partition specs for a
mesh, checking divisibility so that a dim that does not divide degrades to
replication (minicpm's vocab 122753, mamba2-130m's 24 SSM heads on a
16-wide model dim), then into DTensor placements.  The rules and specs are
the JAX package's (``repro/launch/sharding.py``) entry for entry:

  * TP over ``model``: heads/kv/mlp/vocab (+ expert hidden when
    ``moe_sharding == "tp"``); EP over ``model``: the expert axis when
    ``moe_sharding == "ep"``, over ``("data", "model")`` under ``"ep2d"``.
  * FSDP over ``data``: the "embed" axis of every ≥2-D parameter.
  * DP over ``("pod", "data")``: batch dims of inputs and activations;
    ``pod`` never shards parameters unless ``fsdp_over_pod``.
  * Optimizer moments inherit the param spec leaf-wise (q8 scales drop
    the last axis).

A spec is :class:`P`, a tuple whose entries are ``None``, a mesh dim name,
or a tuple of names; a mesh is a ``DeviceMesh`` or a ``{name: size}``
mapping.  The port keeps each layer's parameters apart (lists of per-layer
dicts) where the JAX package stacks them on a leading ``layers`` axis, and
the JAX rule ``keep_1d_replicated`` sees the stacked rank: a per-layer norm
scale is ``[L, d]`` there, sharded over ``data``.  :func:`param_specs`
therefore computes each list leaf's spec on its stacked shape and drops the
leading entry, so a per-layer ``g`` [d] comes out ``P("data")`` as in JAX,
while a top-level 1-D leaf (``final_norm``) stays replicated.

:func:`placements` maps a spec onto one placement per mesh dim: a tuple
entry ``("data", "model")`` is several mesh dims sharding one tensor dim,
which DTensor splits in mesh order (data-major), as JAX splits
``P(("data", "model"))``; an entry in another order than the mesh's raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed._local_tensor import enabled_local_tensor_mode
from torch.distributed.tensor import Replicate, Shard

from .mesh import batch_axes, mesh_shape


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, a mesh dim
    name, or a tuple of names; a tuple of one name is that name, as in
    ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _is_spec(t) -> bool:
    return isinstance(t, P)


def _is_logical(t) -> bool:
    return isinstance(t, tuple) and not isinstance(t, P) and all(
        isinstance(x, (str, type(None))) for x in t)


def logical_rules(cfg, *, fsdp: bool = True, fsdp_over_pod: bool = False,
                  parallelism: str = "2d") -> Dict[Any, Any]:
    ep = (cfg.moe_sharding == "ep") if cfg.moe else False
    embed = None
    if fsdp:
        # ≥300B models shard parameters across pods too (ZeRO over DCI)
        embed = ("pod", "data") if fsdp_over_pod else "data"
    if parallelism == "fsdp_only":
        # the model dim joins data parallelism: params fully sharded over
        # both dims, no TP collectives
        return {
            "layers": None,
            "embed": ("data", "model") if fsdp else None,
            "heads": None, "kv": None, "mlp": None, "vocab": None,
            "expert": "model" if ep else None, "expert_mlp": None,
            None: None,
        }
    ep2d = bool(cfg.moe) and cfg.moe_sharding == "ep2d"
    expert_axis: Any = (("data", "model") if ep2d
                        else ("model" if ep else None))
    return {
        "layers": None,
        "embed": embed,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": expert_axis,
        "expert_mlp": "model" if not (ep or ep2d) else None,
        None: None,
    }


def spec_for_shape(shape: Tuple[int, ...], logical: Tuple, rules, mesh, *,
                   keep_1d_replicated: bool = True) -> P:
    """Translate one logical tuple, dropping axes that don't divide."""
    sizes = mesh_shape(mesh)
    if len(logical) != len(shape):
        raise ValueError(f"logical {logical} vs shape {shape}")
    if keep_1d_replicated and len(shape) < 2:
        return P()
    out = []
    used = set()
    for dim, name in zip(shape, logical):
        mesh_axis = rules.get(name)
        if isinstance(mesh_axis, tuple):  # e.g. FSDP over ("pod", "data")
            axes = tuple(a for a in mesh_axis if a in sizes)
            sz = 1
            for a in axes:
                sz *= sizes[a]
            if axes and not (set(axes) & used) and dim % sz == 0:
                out.append(axes)
                used.update(axes)
            elif axes and dim % sizes[axes[-1]] == 0 \
                    and axes[-1] not in used:
                out.append(axes[-1])
                used.add(axes[-1])
            else:
                out.append(None)
            continue
        if (mesh_axis is None or mesh_axis in used
                or dim % sizes[mesh_axis] != 0):
            out.append(None)
        else:
            out.append(mesh_axis)
            used.add(mesh_axis)
    return P(*out)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_specs(shapes_tree, logical_tree, cfg, mesh, *, fsdp: bool = True,
                fsdp_over_pod: bool = False, parallelism: str = "2d"):
    """Spec tree for params, given their shapes (tensors, fake or meta
    tensors, or shape tuples) and the logical tree of
    :func:`repro_torch.models.logical.param_logical`.  A list is a layer
    stack: each of its leaves is specced on the stacked shape ``[L, ...]``
    with a leading ``"layers"`` axis, as the JAX package stacks it."""
    rules = logical_rules(cfg, fsdp=fsdp, fsdp_over_pod=fsdp_over_pod,
                          parallelism=parallelism)

    def walk(logical, shapes, stack):
        if _is_logical(logical):
            shape = _shape(shapes)
            if stack is None:
                return spec_for_shape(shape, logical, rules, mesh)
            sp = spec_for_shape((stack,) + shape, ("layers",) + logical,
                                rules, mesh)
            return P(*sp[1:])
        if isinstance(logical, dict):
            if set(logical) != set(shapes):
                raise ValueError(f"logical keys {sorted(logical)} vs "
                                 f"{sorted(shapes)}")
            return {k: walk(logical[k], shapes[k], stack) for k in logical}
        if len(logical) != len(shapes):
            raise ValueError(f"stack of {len(logical)} vs {len(shapes)}")
        return [walk(lg, sh, len(logical)) for lg, sh in zip(logical, shapes)]

    return walk(logical_tree, shapes_tree, None)


def batch_spec(global_batch: int, mesh, ndim: int = 2,
               parallelism: str = "2d") -> P:
    """Shard the batch dim over (pod, data) when divisible, else degrade
    (innermost dim dropped first).  fsdp_only folds `model` into the batch
    dims."""
    sizes = mesh_shape(mesh)
    axes = list(batch_axes(sizes))
    if parallelism == "fsdp_only":
        axes.append("model")

    def prod(names):
        n = 1
        for a in names:
            n *= sizes[a]
        return n

    while axes and global_batch % prod(axes):
        axes.pop()
    b_axes = tuple(axes) if axes else None
    return P(b_axes, *([None] * (ndim - 1)))


def opt_state_specs(param_specs_tree, opt_state_shapes):
    """Optimizer-state specs mirroring param specs: m/v inherit the
    param's spec; a q8 moment's scale ``s`` drops the last entry; count is
    replicated."""
    def mom(ps, st):
        if _is_spec(ps):
            if isinstance(st, dict) and set(st) == {"q", "s"}:
                s_spec = P(*ps[:-1], None) if len(ps) else P()
                return {"q": ps, "s": s_spec}
            return ps
        if isinstance(ps, dict):
            return {k: mom(ps[k], st[k]) for k in ps}
        return [mom(a, b) for a, b in zip(ps, st)]

    return {"m": mom(param_specs_tree, opt_state_shapes["m"]),
            "v": mom(param_specs_tree, opt_state_shapes["v"]),
            "count": P()}


# ---------------------------------------------------------------------------
# cache specs (decode/prefill)
# ---------------------------------------------------------------------------

def _cache_leaf_spec(cfg, name: str, shape, b_ax, model_size: int) -> P:
    if name == "len":
        return P()
    if name in ("k", "v"):  # [L, B, S, KV, dh]
        kv, dh = shape[3], shape[4]
        if kv % model_size == 0:
            return P(None, b_ax, None, "model", None)
        if dh % model_size == 0:
            # head-dim-sharded cache: the cache memory divides by |model|
            # when kv_heads < |model| (GQA kv=2..8)
            return P(None, b_ax, None, None, "model")
        return P(None, b_ax, None, None, None)
    if name in ("ckv", "kr"):   # [L, B, S, dc | dr]: the MLA latent
        return P(None, b_ax, None,
                 "model" if shape[3] % model_size == 0 else None)
    if name == "h":             # [L, B, H, N, P]: SSM state
        hshard = ("model" if (cfg.shard_ssm_heads and
                              shape[2] % model_size == 0) else None)
        return P(None, b_ax, hshard, None, None)
    if name in ("conv_x", "conv_bc"):  # [L, B, K-1, C]
        c = shape[3]
        cshard = "model" if (name == "conv_x" and c % model_size == 0) \
            else None
        return P(None, b_ax, None, cshard)
    return P(*([None] + [b_ax] + [None] * (len(shape) - 2)))


def cache_specs(cfg, cache_shapes, mesh, global_batch: int):
    """Specs of the decode caches of ``models.model.init_cache`` (the JAX
    layout, stacked on the layer axis), keyed on each leaf's name: batch
    over (pod, data) when divisible; kv heads over `model` when they
    divide it, else the head dim (GQA kv < |model|); the MLA latent over
    `model`; `len` replicated."""
    b_ax = batch_spec(global_batch, mesh, ndim=1)[0]
    model_size = mesh_shape(mesh)["model"]

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else _cache_leaf_spec(cfg, k, _shape(v), b_ax,
                                          model_size))
                for k, v in tree.items()}

    return walk(cache_shapes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """One DTensor placement per mesh dim, in mesh order: ``Shard(i)``
    where the spec shards tensor dim ``i`` over that mesh dim, else
    ``Replicate()``."""
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh dim {a!r} in "
                                 f"{names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in the "
                             f"mesh's order {names}; DTensor splits a dim "
                             f"over several mesh dims in mesh order")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec} uses mesh dim {names[j]!r} "
                                 f"twice")
            out[j] = Shard(i)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shard shape of a tensor of ``shape`` under ``spec`` (the specs
    here only shard dims that divide evenly)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                if out[i] % sizes[a]:
                    raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                     f"divide over {a!r} ({sizes[a]})")
                out[i] //= sizes[a]
    return tuple(out)


def shard_tree(tree, specs, mesh):
    """Each tensor of ``tree`` distributed over the DeviceMesh ``mesh``
    by its spec in ``specs`` (a tree of the same structure): every rank
    keeps a copy of its block (``distribute_tensor`` from the whole
    tensor), so a step that updates its arguments in place leaves
    ``tree`` as it was."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s):
        if _is_spec(s):    # a copy: the steps update their arguments
            return distribute_tensor(t.detach().clone(), mesh,
                                     placements(s, mesh))
        if isinstance(s, dict):
            return {k: walk(t[k], s[k]) for k in s}
        return [walk(a, b) for a, b in zip(t, s)]

    return walk(tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree, depth first (a spec is a tuple: generic
    tree helpers would take its entries for leaves)."""
    if _is_spec(specs):
        return [specs]
    vals = specs.values() if isinstance(specs, dict) else specs
    return [leaf for v in vals for leaf in spec_leaves(v)]


def per_rank(mesh, fn):
    """``fn(coord)`` for this rank's coordinate on ``mesh`` (a tuple, one
    entry per mesh dim); under ``LocalTensorMode`` once per simulated rank,
    joined into a LocalTensor (``fn`` returns a tensor there)."""
    lm = enabled_local_tensor_mode()
    if lm is None:
        return fn(tuple(mesh.get_coordinate()))
    layout = mesh.mesh
    return lm.rank_map(lambda r: fn(tuple(
        int(c) for c in (layout == r).nonzero()[0])))


def shard_offset(mesh, dims, n: int, device):
    """This rank's first index along a tensor dim of ``n`` entries that
    shards over the mesh dims ``dims`` (indices, in mesh order: major to
    minor), as a 0-d tensor on ``device`` (:func:`per_rank`): where a
    vocab-parallel embedding's rows or cross-entropy's columns start."""
    block = n // math.prod(mesh.size(m) for m in dims)

    def first(coord):
        k = 0
        for m in dims:
            k = k * mesh.size(m) + coord[m]
        return torch.tensor(k * block, device=device)

    return per_rank(mesh, first)


def block_slices(shape, spec: P, mesh, coord) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at ``coord`` holds
    under ``spec`` (``PartitionSpec`` semantics: a dim over several mesh
    dims splits major-to-minor in the entry's order)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            k *= sizes[a]
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)
