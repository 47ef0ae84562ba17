"""Plain torch versions of the flash-attention kernels: masked softmax
attention over the whole score matrix, in float32, and its gradients
written out explicitly (the backward kernel's plain version)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, sm_scale=None,
                        q_off: int = 0) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,KV,Sk,D] → [B,H,Sq,D] (q's dtype).

    Query ``i`` sits at position ``q_off + i`` and key ``j`` at ``j``.  Rows
    with no visible key are 0.
    """
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = q_off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)          # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool = True,
                            window: Optional[int] = None, sm_scale=None,
                            q_off: int = 0):
    """The gradients of :func:`flash_attention_ref` at q [B,H,Sq,D], k
    [B,KV,Sk,D], v [B,KV,Sk,Dv] for the output gradient do [B,H,Sq,Dv] →
    (dq, dk, dv) in the inputs' dtypes, computed in float32 from the
    formulas the backward kernel uses (P the masked softmax, masked
    entries 0):

        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − rowsum(dP ∘ P)),
        dQ = scale·dS·K,  dK = scale·dSᵀ·Q,

    dK and dV summed over each GQA group.  (The kernel takes rowsum(dO ∘ O)
    for rowsum(dP ∘ P); the two are equal for the exact O.)"""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    qpos = q_off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)          # fully masked rows
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk_h.reshape(b, kv, g, sk, d).sum(2)
    dv = dv_h.reshape(b, kv, g, sk, v.shape[3]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_error_bound(q, k, v, want, *, p_roundings: int = 1,
                     **masks) -> torch.Tensor:
    """Elementwise bound on ``|o - want|`` for two bf16 attention outputs of
    the same q, k, v [B,H,Sq,D] / [B,KV,Sk,D] and masks: ``want`` from this
    plain version, ``o`` from one that computes in fp32 too, except that
    ``p_roundings`` of the two round P to bf16 before P·V.

    With u = 2^-8 (half a bf16 ulp, relative) and a = P·|V| (row i, column
    d: Σ_j P_ij |v_jd|): each rounding of P moves o_id by at most u·a_id,
    each rounding of the output by at most u·|o_id|, and fp32 summation
    order over up to 4096 keys (scores included) by less than 2^-11·a_id.
    The bound follows each row's own scale, so a wrong late row or tile is
    not hidden behind the large values of the early ones.
    """
    a = flash_attention_ref(q.float(), k.float(), v.float().abs(), **masks)
    return (p_roundings * 2 ** -8 + 2 ** -11) * a \
        + 2 ** -7 * want.float().abs()
