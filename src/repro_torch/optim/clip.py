"""Global-norm gradient clipping (fp32 accumulation)."""
from __future__ import annotations

import torch

from .tree import tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each summed in fp32."""
    sq = sum(x.float().square().sum() for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so that their global norm is at most ``max_norm``
    → ``(grads, norm before)``.  The scale is applied in each gradient's
    own dtype, as in the JAX package; unlike its new tree, the port scales
    the given tensors in place (a train step's gradients are its own), so
    no second copy of them is made."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn
