"""Mixture-of-Experts with D4M-style sparse dispatch.

Top-k gating gives, for every sequence, a sparse associative array
``G : (token × expert) → gate``.  Dispatch and combine are the two
``(+, ×)`` semiring contractions

    X_buf = Gᵀ ⊗.⊕ X          (expert, slot, d)  ← gather tokens per expert
    Y     = G  ⊗.⊕ FFN(X_buf) (token, d)         ← weighted combine

realized, as in the JAX package (``repro/models/moe.py``), as a stable sort
of each sequence's entries by expert, a scatter into a buffer of
``capacity`` slots per expert (entries past it are dropped), one batched
product per projection over all experts, and a weighted scatter-add back to
token order.  The JAX package vmaps its per-sequence dispatch over the
batch; here one sort, one scatter and one ``index_add_`` cover every
sequence at once, and a sort never crosses a sequence.  The expert buffer
is laid out ``[E, B·C, d]`` (the JAX one is ``[B, E, C, d]``), so that each
projection is one ``torch.bmm`` over the experts with no permute: slot
``(b, e, c)`` is row ``(e·B + b)·C + c``.

Two routers: ``softmax_topk`` (Mixtral: softmax → top-k → renormalize, and
the switch-transformer load-balancing aux loss) and ``sigmoid_topk``
(DeepSeek-V3: sigmoid affinities, top-k of ``scores + e_bias``, gates
renormalized over the selected experts and scaled by ``routed_scale``, no
aux loss; the bias moves outside the gradient by
:func:`update_router_bias`), and an optional always-on shared expert.
``router`` and ``e_bias`` stay fp32 at any ``param_dtype``
(``layers.FP32_LEAVES``).  The expert FFN's activation is ``F.silu``, as
in the dense MLP (``layers.apply_mlp``): it holds the JAX package's bf16
results within the tests' ``2^-6 · max`` (the SSD block's JAX-rounded
``ssm.silu`` is not needed here).  The JAX package's ``constrain_batch``
pins are hints to XLA's partitioner with no meaning on one card, so they
are left out.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .layers import Params, _normal, init_linear, linear

# one list per open routing_log() block; apply_moe appends to each
_ROUTING_LOGS: List[list] = []


def init_moe(gen: torch.Generator, cfg) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m["d_ff"], m["n_experts"]
    dt, dev = cfg.param_dtype, gen.device
    # stacked expert FFNs (swiglu), the expert on axis 0
    p: Params = {"router": _normal(gen, (d, e), d ** -0.5, torch.float32),
                 "gate": _normal(gen, (e, d, f), d ** -0.5, dt),
                 "up": _normal(gen, (e, d, f), d ** -0.5, dt),
                 "down": _normal(gen, (e, f, d), f ** -0.5, dt)}
    if m.get("router_bias", False):  # DeepSeek aux-loss-free balancing bias
        p["e_bias"] = torch.zeros((e,), dtype=torch.float32, device=dev)
    if m.get("shared_expert", 0):
        fs = f * m["shared_expert"]
        p["shared_gate"] = init_linear(gen, d, fs, dtype=dt)
        p["shared_up"] = init_linear(gen, d, fs, dtype=dt)
        p["shared_down"] = init_linear(gen, fs, d, dtype=dt)
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, ties to the lower index as
    ``jax.lax.top_k`` breaks them.  ``torch.topk`` does not: on [0.1, 0.3,
    0.3, 0.3, 0.2] it picks experts 1 and 3, JAX 1 and 2.  Router scores
    come from bf16 logits, so ties are real; a stable descending sort
    keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg, x: torch.Tensor):
    """Router → (gates [B,S,k] in ``x``'s dtype, expert_idx [B,S,k] int64,
    aux_loss, load [E])."""
    m = cfg.moe
    e, k = m["n_experts"], m["top_k"]
    # the product in the activations' dtype, then fp32, as in JAX
    logits = (x @ p["router"].to(x.dtype)).float()          # [B,S,E]
    if m.get("router_type", "softmax_topk") == "sigmoid_topk":
        scores = torch.sigmoid(logits)
        sel = scores + p["e_bias"] if "e_bias" in p else scores
        _, idx = _top_k(sel, k)
        g = torch.gather(scores, -1, idx)
        gates = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
        gates = gates * m.get("routed_scale", 1.0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        g, idx = _top_k(probs, k)
        gates = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
        # switch-transformer load-balance aux loss
        frac_tokens = F.one_hot(idx, e).float().sum(-2).mean((0, 1))
        frac_probs = probs.mean((0, 1))
        aux = e * (frac_tokens / k * frac_probs).sum()
    load = F.one_hot(idx, e).float().sum((0, 1, 2))
    return gates.to(x.dtype), idx, aux, load


def _dispatch(x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
              n_experts: int, capacity: int):
    """Sort-based dispatch of every sequence (the Gᵀ ⊗.⊕ X contraction;
    the JAX package's ``_dispatch_seq`` over each sequence).

    x [B,S,d], idx [B,S,k], gates [B,S,k] → buffer [E, B·C, d] and the
    combine metadata (rows read, destination rows, gates, keep), each
    [B, S·k] in expert-sorted order.  Entry j of a sequence is token
    ``j // k``; its slot is its rank among the sequence's entries of its
    expert, and ``keep = slot < capacity``.  Where the JAX package writes
    a dropped entry out of bounds with ``mode="drop"``, here it goes to a
    trash row past the buffer's end, cut off before it is returned (never
    a wrapped index)."""
    b, s, k = idx.shape
    d = x.shape[-1]
    dev = x.device
    e_flat = idx.reshape(b, s * k)
    order = torch.argsort(e_flat, dim=1, stable=True)        # group by expert
    e_sorted = e_flat.gather(1, order)
    tok_sorted = order // k
    gate_sorted = gates.reshape(b, s * k).gather(1, order)
    counts = torch.zeros((b, n_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = counts.cumsum(1) - counts                       # exclusive prefix
    pos = torch.arange(s * k, device=dev) - starts.gather(1, e_sorted)
    keep = pos < capacity
    first = (e_sorted * b + torch.arange(b, device=dev)[:, None]) * capacity
    trash = n_experts * b * capacity
    buf = x.new_zeros((trash + 1, d))
    src = torch.arange(b, device=dev)[:, None] * s + tok_sorted
    buf.index_copy_(0, torch.where(keep, first + pos, trash).reshape(-1),
                    x.reshape(b * s, d)[src.reshape(-1)])
    # a dropped entry reads its expert's slot 0 and weighs it by 0, as JAX
    rows = first + torch.where(keep, pos, 0)
    return buf[:trash].view(n_experts, b * capacity, d), \
        (rows, src, gate_sorted, keep)


def _combine(y_buf: torch.Tensor, meta, b: int, s: int) -> torch.Tensor:
    """Weighted scatter-add back to token order (the G ⊗.⊕ Y contraction),
    in ``y_buf``'s dtype.  Each token gets its k terms added to zero by
    ``index_add_`` in an order the card's atomics choose; for k ≤ 2 that
    order cannot change the result (0 + a is exact and a + b = b + a, each
    rounded once), so it equals the JAX package's scatter bit for bit.  At
    k > 2 the sums may round apart."""
    rows, src, gate_sorted, keep = meta
    d = y_buf.shape[-1]
    vals = y_buf.reshape(-1, d)[rows.reshape(-1)].view(*rows.shape, d)
    vals = vals * (gate_sorted * keep.to(gate_sorted.dtype))[..., None]
    out = y_buf.new_zeros((b * s, d))
    out.index_add_(0, src.reshape(-1), vals.reshape(-1, d))
    return out.view(b, s, d)


@contextlib.contextmanager
def routing_log():
    """Record every :func:`apply_moe` call in the block: its expert indices
    ``idx`` [B, S, k] and the number of (token, expert) entries it
    ``dropped`` at capacity, both device tensors (read them after the
    block: no sync inside), and the number ``routed``.  Yields the list
    they are appended to, one dict per call."""
    log: list = []
    _ROUTING_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTING_LOGS.remove(log)


def apply_moe(p: Params, cfg, x: torch.Tensor):
    """x: [B, S, d] → (y [B, S, d], aux_loss, expert_load [E])."""
    m = cfg.moe
    b, s, _ = x.shape
    e, k = m["n_experts"], m["top_k"]
    cf = m.get("capacity_factor", 1.25)
    cap = int(max(1, round(s * k / e * cf)))     # Python's round, as in JAX
    gates, idx, aux, load = _route(p, cfg, x)
    buf, meta = _dispatch(x, idx, gates, e, cap)
    for log in _ROUTING_LOGS:
        log.append({"idx": idx, "dropped": (~meta[3]).sum(),
                    "routed": meta[3].numel()})
    # one product per projection over all experts: [E, B·C, d] @ [E, d, f];
    # in place when serving, out of place where autograd saves the operands
    # (the same values).  Under a mesh the buffers stay batch-sharded (the
    # B·C rows are batch-major), as the JAX package pins them, except under
    # 2-D expert parallelism, where they follow the expert axis
    from .pjit_utils import constrain_batch
    pin = ((lambda t: t) if cfg.moe_sharding == "ep2d"
           else (lambda t: constrain_batch(t, dim=1)))
    buf = pin(buf)
    g = torch.bmm(buf, p["gate"])
    if torch.is_grad_enabled() and g.requires_grad:
        h = F.silu(g) * torch.bmm(buf, p["up"])
    else:
        h = F.silu(g, inplace=True).mul_(torch.bmm(buf, p["up"]))
    y = _combine(pin(torch.bmm(pin(h), p["down"])), meta, b, s)
    if "shared_gate" in p:  # DeepSeek shared expert — always on
        y = y + linear(p["shared_down"],
                       F.silu(linear(p["shared_gate"], x)) *
                       linear(p["shared_up"], x))
    return y, aux, load


def update_router_bias(e_bias: torch.Tensor, load: torch.Tensor,
                       rate: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 aux-loss-free balancing: nudge under-loaded experts up.

    Applied outside the gradient (in the train step) from per-step loads.
    """
    return e_bias + rate * torch.sign(load.mean() - load)


__all__ = ["apply_moe", "init_moe", "routing_log", "update_router_bias"]
