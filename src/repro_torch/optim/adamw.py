"""AdamW with selectable moment-state precision (fp32 / bf16 / int8-blocked),
the JAX package's ``repro.optim.adamw`` on torch tensors.

Moments are stored in fp32, in bf16, or as int8 with per-block
(128-element) fp32 scales — the standard 8-bit Adam construction
(block-wise quantization, dequantize → update → requantize each step).
Precision is a per-run policy (``launch.steps.TrainOptions``).

State layout mirrors the parameter tree: each leaf is either a tensor
(fp32 / bf16 moments) or a dict {"q": int8[...], "s": f32[..., n_blocks]}
(int8), plus the step ``count`` (int32).  The math runs in fp32 whatever
the storage; parameters are updated in their own dtype.  The port updates
the parameters and the stored moments in place (the JAX package returns new
trees; here that would hold a second copy of every parameter and moment),
and returns them.  The JAX package runs a huge stacked leaf layer by layer
over its leading axis; the port's stacks are per-layer lists already, and
a leaf of more than :data:`CHUNK_ELEMS` elements is updated in slices along
its leading axis, so the fp32 temporaries stay small (an elementwise
update: the same values).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .tree import is_q8, tree_leaves, tree_map

Q8_BLOCK = 128
CHUNK_ELEMS = 64 * 1024 * 1024  # the JAX package's CHUNK_THRESHOLD


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def quantize_q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Shape-preserving int8 quantization with per-last-dim-block scales:
    ``q`` keeps ``x``'s shape, ``s`` is ``x.shape[:-1] + (ceil(last /
    128),)``.  Round half to even, as ``jnp.round``, so the two packages
    agree bit for bit."""
    x32 = x.float()
    last = x.shape[-1] if x.dim() else 1
    pad = (-last) % Q8_BLOCK
    xp = F.pad(x32.reshape(x.shape or (1,)), (0, pad))
    nblk = (last + pad) // Q8_BLOCK
    blocks = xp.reshape(xp.shape[:-1] + (nblk, Q8_BLOCK))
    scale = blocks.abs().amax(dim=-1) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(xp.shape)[..., :last].to(torch.int8)
    return {"q": q.reshape(x.shape), "s": scale}


def dequantize_q8(packed: Dict[str, torch.Tensor], shape,
                  dtype=torch.float32) -> torch.Tensor:
    q, s = packed["q"], packed["s"]
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    pad = (-last) % Q8_BLOCK
    qp = F.pad(q.float().reshape(q.shape or (1,)), (0, pad))
    nblk = (last + pad) // Q8_BLOCK
    blocks = qp.reshape(qp.shape[:-1] + (nblk, Q8_BLOCK)) * s[..., None]
    return blocks.reshape(qp.shape)[..., :last].reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# moment-state storage policies
# ---------------------------------------------------------------------------

def _store_into(stored, x: torch.Tensor, policy: str) -> None:
    """Write the fp32 moment ``x`` into its storage, in place."""
    if policy == "q8":
        packed = quantize_q8(x)
        stored["q"].copy_(packed["q"])
        stored["s"].copy_(packed["s"])
    elif policy in ("fp32", "bf16"):
        stored.copy_(x)                  # the cast rounds to nearest even
    else:
        raise ValueError(policy)


def _load(stored, shape, policy: str) -> torch.Tensor:
    if policy == "q8":
        return dequantize_q8(stored, shape)
    return stored.float()


def _zeros_like_stored(p: torch.Tensor, policy: str):
    if policy == "q8":
        last = p.shape[-1] if p.dim() else 1
        nblk = (last + Q8_BLOCK - 1) // Q8_BLOCK
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(p.shape[:-1] + (nblk,), dtype=torch.float32,
                                 device=p.device)}
    if policy not in ("fp32", "bf16"):
        raise ValueError(policy)
    dt = torch.float32 if policy == "fp32" else torch.bfloat16
    return torch.zeros(p.shape, dtype=dt, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def policies(state_policy: str) -> Tuple[str, str]:
    """Per-moment storage: the second moment is ratio-sensitive (a block's
    small v entries quantize to 0 → exploding m/√v steps), so 'q8' means
    m:int8 + v:bf16 — the memory win stays (3 B vs 8 B per param)."""
    if state_policy == "q8":
        return "q8", "bf16"
    return state_policy, state_policy


def adamw_init(params, *, state_policy: str = "fp32"):
    mp, vp = policies(state_policy)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: _zeros_like_stored(p, mp), params),
            "v": tree_map(lambda p: _zeros_like_stored(p, vp), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _slices(p: torch.Tensor):
    """Row ranges of ``p``'s leading axis, each under CHUNK_ELEMS elements
    (one range for a leaf that small, or for one of fewer than two axes:
    its int8 scales do not split along it)."""
    n = p.shape[0] if p.dim() >= 2 else 1
    if p.numel() <= CHUNK_ELEMS or n == 1:
        return [slice(None)]
    rows = max(1, CHUNK_ELEMS // (p.numel() // n))
    return [slice(i, i + rows) for i in range(0, n, rows)]


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, state_policy: str = "fp32"):
    """One AdamW step → ``(params, opt_state)``, both updated in place.

    Math runs in fp32 regardless of storage policy; params are updated in
    their own dtype (bf16 master-less update, as in the JAX package).
    """
    count = opt_state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    m_policy, v_policy = policies(state_policy)

    def upd(p, g, m_st, v_st):
        g32 = g.float()
        m = _load(m_st, p.shape, m_policy)
        v = _load(v_st, p.shape, v_policy)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / c1
        vhat = v / c2
        step = mhat / (torch.sqrt(vhat) + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + weight_decay * p32))
        _store_into(m_st, m, m_policy)
        _store_into(v_st, v, v_policy)

    def part(x, sl):
        return {k: t[sl] for k, t in x.items()} if is_q8(x) else x[sl]

    for p, g, m_st, v_st in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["m"]),
                                tree_leaves(opt_state["v"])):
        for sl in _slices(p):
            upd(p[sl], g[sl], part(m_st, sl), part(v_st, sl))
    opt_state["count"] = count
    return params, opt_state
