"""Gradient compression for a bandwidth-scarce all-reduce (the JAX
package's ``repro.distributed.compression`` on torch tensors).

int8 block quantization with **error feedback**: the quantization residual
is carried to the next step so the compressed SGD direction stays unbiased
in the long run (standard EF-SGD construction).  Intended for the gradient
sync across the slowest link (between pods, or between hosts of cards);
the reduction inside a host stays full-precision.

The quantizer is the optimizer's shape-preserving q8 layout
(``optim.adamw.quantize_q8``: ``q`` int8 of the gradient's shape, ``s``
fp32 per 128-element block of its last axis), so the two packages give the
same ``q``.  Everything runs as torch ops on the gradients' device, over
the port's parameter trees (``optim/tree.py``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.optim.adamw import dequantize_q8, quantize_q8
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten


def compress_tree(grads, error_state: Optional[Any] = None):
    """(compressed, new_error_state).  compressed leaves: {"q","s"}; the
    error state is fp32 in the gradients' structure."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    def one(g, e):
        corrected = g.float() + e
        packed = quantize_q8(corrected)
        deq = dequantize_q8(packed, g.shape)
        return packed, corrected - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def decompress_tree(compressed, shapes_like, dtype=torch.float32):
    """The dequantized tree, in ``shapes_like``'s structure and shapes."""
    return tree_map(lambda s, packed: dequantize_q8(packed, s.shape, dtype),
                    shapes_like, compressed)
