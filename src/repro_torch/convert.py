"""State carried between the JAX package and the port, as numpy arrays.

A JAX ``AssocTensor`` is four arrays plus host keyspaces; the port's is the
same four as torch tensors.  :func:`from_jax_state` takes the numpy form of
the JAX one (``np.asarray`` of each field and ``KeySpace.keys``) and
:func:`to_numpy_state` gives the same form back, so arrays move between
the packages without either importing the other.

A JAX ``DistAssoc`` holds every shard as one row of stacked ``[P, cap]``
arrays; a port ``DistAssoc`` holds one shard per rank.
:func:`from_jax_dist_state` takes the stacked numpy arrays, the keyspaces
and ``row_bounds`` and gives a rank its own shard;
:func:`to_numpy_dist_state` gives one rank's shard back as numpy.

Model parameters and decode caches move the same way
(:func:`from_jax_params`/:func:`to_numpy_params`,
:func:`from_jax_cache`/:func:`to_numpy_cache`).  Both packages keep the
same leaves under the same names, and a linear weight ``w`` as
``[d_in, d_out]`` (``y = x @ w``).  The JAX package stacks the layers on
axis 0 under ``dense_stack``, ``moe_stack``, ``mamba_stack``,
``enc_stack`` and ``dec_stack``; the port keeps a list of per-layer dicts,
as long as the stack's leading axis (a
moe config's ``first_dense`` layers are its ``dense_stack``, the rest its
``moe_stack``; the hybrid's ``shared`` block is one layer, and its
``shared_lora`` stays stacked on the invocation axis in both; deepseek-v3's
``mtp`` block is one unstacked subtree in both; whisper's learned
positions ``pos`` and its encoder's ``enc_pos`` are plain leaves, and its
cache's ``cross_kv`` is a ``k``/``v`` stack with no ``len``).  numpy has
no bfloat16, so bf16 leaves travel as float32 (exact both ways); the
leaves that the JAX init keeps in fp32 at any ``param_dtype``
(``models.layers.FP32_LEAVES``: the SSM mixer's and the MoE router's) and
the SSM state ``h`` stay fp32.

AdamW's state moves likewise (:func:`from_jax_opt_state`/
:func:`to_numpy_opt_state`): the moments ``m`` and ``v`` mirror the
parameter tree, their stacks split into per-layer lists as the
parameters', each leaf fp32 or bf16 by the state policy, or an int8 moment
``{"q": int8, "s": fp32 scales}`` (q8's ``m``) whose two arrays split on
the layer axis alike; ``count`` is an int32 scalar.  So a JAX train step
and a port train step can start from one state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.assoc_tensor import AssocTensor, resolve_device
from .core.dist_assoc import DistAssoc
from .core.keyspace import KeySpace
from .core.mesh import Mesh
from .models.layers import FP32_LEAVES
from .optim.adamw import policies

# the parameter stacks that the JAX package stacks on a leading layer axis
LAYER_STACKS = ("dense_stack", "moe_stack", "mamba_stack", "enc_stack",
                "dec_stack")

__all__ = ["from_jax_cache", "from_jax_dist_state", "from_jax_opt_state",
           "from_jax_params", "from_jax_state", "to_numpy_cache",
           "to_numpy_dist_state", "to_numpy_opt_state", "to_numpy_params",
           "to_numpy_state"]


def from_jax_state(rows, cols, vals, nnz, row_keys, col_keys,
                   val_keys: Optional[np.ndarray] = None, *,
                   device="cuda") -> AssocTensor:
    """Build the port's ``AssocTensor`` from the numpy form of a JAX one.

    ``row_keys``/``col_keys``/``val_keys`` are the ``KeySpace.keys`` arrays
    (sorted and unique already); ``val_keys`` is None for numeric values.
    """
    dev = resolve_device(device)

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    return AssocTensor(
        tensor(rows, np.int32), tensor(cols, np.int32),
        tensor(vals, np.float32),
        torch.tensor(int(np.asarray(nnz)), dtype=torch.int32, device=dev),
        KeySpace.from_sorted_unique(np.asarray(row_keys)),
        KeySpace.from_sorted_unique(np.asarray(col_keys)),
        None if val_keys is None
        else KeySpace.from_sorted_unique(np.asarray(val_keys)))


def to_numpy_state(t: AssocTensor) -> dict:
    """The inverse of :func:`from_jax_state`: a dict of numpy arrays with
    keys ``rows, cols, vals, nnz, row_keys, col_keys, val_keys``."""
    return {
        "rows": t.rows.cpu().numpy(),
        "cols": t.cols.cpu().numpy(),
        "vals": t.vals.cpu().numpy(),
        "nnz": int(t.nnz),
        "row_keys": t.row_space.keys,
        "col_keys": t.col_space.keys,
        "val_keys": None if t.val_space is None else t.val_space.keys,
    }


def from_jax_dist_state(rows, cols, vals, nnz, row_keys, col_keys,
                        row_bounds, mesh: Mesh,
                        val_keys: Optional[np.ndarray] = None) -> DistAssoc:
    """This rank's ``DistAssoc`` from the numpy form of a JAX one: stacked
    ``[P, cap]`` ``rows``/``cols``/``vals``, ``[P]`` ``nnz`` (P the mesh's
    size), the keyspaces' keys and ``row_bounds``.  The shard lands on
    ``mesh.device``."""
    rows = np.asarray(rows)
    if rows.shape[0] != mesh.size:
        raise ValueError(f"{rows.shape[0]} shards for a mesh of "
                         f"{mesh.size} ranks")
    s = mesh.rank
    local = from_jax_state(rows[s], np.asarray(cols)[s],
                           np.asarray(vals)[s], np.asarray(nnz)[s],
                           row_keys, col_keys, val_keys, device=mesh.device)
    return DistAssoc(local, mesh,
                     row_bounds=np.asarray(row_bounds, np.int64))


def to_numpy_dist_state(d: DistAssoc) -> dict:
    """This rank's shard as numpy: :func:`to_numpy_state` of ``d.local``
    plus ``row_bounds`` and ``rank``."""
    return {**to_numpy_state(d.local),
            "row_bounds": np.asarray(d.row_bounds), "rank": d.mesh.rank}


# -- model parameters and decode caches ------------------------------------------

def _map(fn, tree, name: str = ""):
    """``fn(leaf)``, or ``fn(leaf, name)`` with each leaf's own key when
    ``name`` is given, over a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k if name else "") for k, v in tree.items()}
    return fn(tree, name) if name else fn(tree)


def from_jax_params(params_np: dict, cfg, *, device="cuda") -> dict:
    """The port's parameters from the numpy form of a JAX parameter pytree
    (``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``): each
    leaf in ``cfg.param_dtype`` on ``device`` (those of
    ``models.layers.FP32_LEAVES`` in fp32), and each layer stack (layers on
    axis 0) split into a list of per-layer dicts, one for each entry of
    its leading axis."""
    dev = resolve_device(device)

    def tensor(x, key):
        dtype = torch.float32 if key in FP32_LEAVES else cfg.param_dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, dtype)

    return _split_stacks(params_np, tensor)


def _split_stacks(tree_np: dict, leaf) -> dict:
    """``leaf(array, key)`` of every leaf of a numpy tree in the JAX layout
    (``key`` the leaf's own name), each layer stack split into a list of
    per-layer dicts, one for each entry of its leading axis."""
    out = {}
    for name, sub in tree_np.items():
        if name in LAYER_STACKS:
            n = len(_first_leaf(sub))
            out[name] = [_map(lambda x, k, i=i: leaf(np.asarray(x)[i], k),
                              sub, name) for i in range(n)]
        else:
            out[name] = _map(leaf, sub, name)
    return out


def to_numpy_params(params: dict) -> dict:
    """The inverse of :func:`from_jax_params`: float32 numpy leaves (int8
    ones, an int8 moment's ``q``, stay int8), with each layer stack stacked
    on axis 0 as in the JAX package."""
    def arr(t):
        t = t.detach().cpu()
        return t.numpy() if t.dtype == torch.int8 else t.float().numpy()

    out = {}
    for name, sub in params.items():
        if name in LAYER_STACKS:
            out[name] = _stack([_map(arr, layer) for layer in sub])
        else:
            out[name] = _map(arr, sub)
    return out


def from_jax_opt_state(opt_np: dict, state_policy: str, *,
                       device="cuda") -> dict:
    """The port's AdamW state from the numpy form of a JAX one
    (``jax.tree.map(np.asarray, opt_state)``) under ``state_policy``
    (fp32 | bf16 | q8): each moment leaf fp32 or bf16 as its policy says,
    an int8 moment's ``q`` int8 and ``s`` fp32 (q8: ``m`` int8, ``v``
    bf16), on ``device``, each layer stack split into per-layer lists as
    :func:`from_jax_params` splits the parameters (no parameter leaf is
    named ``q`` or ``s``)."""
    dev = resolve_device(device)

    def moment(tree, policy):
        def leaf(x, key):
            if key == "q":
                return torch.from_numpy(np.array(x, np.int8)).to(dev)
            dtype = torch.float32 if key == "s" or policy == "fp32" \
                else torch.bfloat16
            return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)
        return _split_stacks(tree, leaf)

    m_policy, v_policy = policies(state_policy)
    return {"m": moment(opt_np["m"], m_policy),
            "v": moment(opt_np["v"], v_policy),
            "count": torch.tensor(int(np.asarray(opt_np["count"])),
                                  dtype=torch.int32, device=dev)}


def to_numpy_opt_state(opt_state: dict) -> dict:
    """The inverse of :func:`from_jax_opt_state`: the moments as
    :func:`to_numpy_params` gives a tree back, ``count`` an int32
    scalar."""
    return {"m": to_numpy_params(opt_state["m"]),
            "v": to_numpy_params(opt_state["v"]),
            "count": np.int32(int(opt_state["count"]))}


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


def from_jax_cache(cache_np: dict, cfg, *, device="cuda") -> dict:
    """The port's decode cache from the numpy form of a JAX one (the same
    layout in both packages, stacked on the layer or invocation axis): the
    attention stacks' ``k``/``v`` (MLA's ``ckv``/``kr``) and the SSM conv
    tails in ``cfg.compute_dtype``, the SSM state ``h`` in fp32, ``len``
    int32."""
    dev = resolve_device(device)

    def tensor(x, key):
        if key == "len":
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)
        dtype = torch.float32 if key == "h" else cfg.compute_dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, dtype)

    return {name: {key: tensor(x, key) for key, x in st.items()}
            for name, st in cache_np.items()}


def to_numpy_cache(cache: dict) -> dict:
    """The inverse of :func:`from_jax_cache`: float32 tensors, int32
    ``len``."""
    def arr(t):
        return t.cpu().numpy() if t.dtype == torch.int32 else \
            t.float().cpu().numpy()

    return {name: {key: arr(t) for key, t in st.items()}
            for name, st in cache.items()}
