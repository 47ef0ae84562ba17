"""State carried between the JAX package and the port, as numpy arrays.

A JAX ``AssocTensor`` is four arrays plus host keyspaces; the port's is the
same four as torch tensors.  :func:`from_jax_state` takes the numpy form of
the JAX one (``np.asarray`` of each field and ``KeySpace.keys``) and
:func:`to_numpy_state` gives the same form back, so arrays move between
the packages without either importing the other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.assoc_tensor import AssocTensor, resolve_device
from .core.keyspace import KeySpace

__all__ = ["from_jax_state", "to_numpy_state"]


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
