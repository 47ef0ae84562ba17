"""Mamba2 (SSD — state-space duality) blocks, chunked.

The SSD recurrence per head (state size N, head dim P):

    h_t = exp(Δ_t·A) · h_{t-1} + Δ_t · B_t xᵗ_t        h ∈ R^{N×P}
    y_t = C_tᵀ h_t + D · x_t

is evaluated chunk-parallel (chunk Q): within a chunk the dual "masked
attention" form ``Y = ((C Bᵀ) ∘ L) X`` runs as batched matmuls, and a short
loop over chunks carries the inter-chunk state, as in the JAX package
(``repro/models/ssm.py``).  Decode is the exact single-step recurrence on a
carried ``(conv_tail, ssm_state)`` cache: O(1) memory in sequence length.

The JAX package writes the chunk contractions as einsums and leaves their
order to XLA.  ``torch.einsum`` contracts left to right, so here each one
is spelled out as broadcasts and one batched matmul, with the largest
intermediate named beside it.  At zamba2-7b's prefill (B 4, 16 chunks of
Q 128, 112 heads, N 64, P 64) that is the intra-chunk decay, [B, C, G, R,
Q, Q] fp32: 470 MB per layer, freed before the next.

``dt_bias``, ``a_log``, ``d_skip`` and the state ``h`` are fp32 whatever
``param_dtype`` is (``layers.FP32_LEAVES``), and the scan runs in fp32.
Chunked prefill runs a prompt window by window: each window's scan starts
from the cached state ``h`` and its convs from the cached tails, as in the
JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Params, _normal, init_linear, linear, rms_norm_simple


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1/(1 + exp(−x))``, one rounding to ``x``'s dtype per op, as
    the JAX package's ``jax.nn.silu`` computes it (XLA splits the logistic
    into exp, add and divide, each rounded to bf16).  ``F.silu`` rounds once
    and differs in a quarter of the bf16 outputs by an ulp; the SSD scan's
    sums over the chunk amplify that past two percent of a block's output,
    so the block keeps the JAX package's rounding."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _dims(cfg) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, d_state N, head_dim P, d_conv K, n_groups G, heads H)."""
    m = cfg.ssm
    d_in = m["d_inner"]
    return (d_in, m["d_state"], m["head_dim"], m["d_conv"],
            m.get("n_groups", 1), d_in // m["head_dim"])


def init_mamba2(gen: torch.Generator, cfg) -> Params:
    d_in, n, _, conv, g, nh = _dims(cfg)
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    # in_proj → [z, x, B, C, dt]
    p: Params = {"in_z": init_linear(gen, d, d_in, dtype=dt),
                 "in_x": init_linear(gen, d, d_in, dtype=dt),
                 "in_b": init_linear(gen, d, g * n, dtype=dt),
                 "in_c": init_linear(gen, d, g * n, dtype=dt),
                 "in_dt": init_linear(gen, d, nh, dtype=dt)}
    p["dt_bias"] = torch.zeros((nh,), dtype=torch.float32, device=dev)
    p["a_log"] = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev))
    p["d_skip"] = torch.ones((nh,), dtype=torch.float32, device=dev)
    # depthwise causal convs (the x part and the B/C part)
    p["conv_x"] = _normal(gen, (conv, d_in), 0.5, dt)
    p["conv_bc"] = _normal(gen, (conv, 2 * g * n), 0.5, dt)
    p["norm_g"] = torch.ones((d_in,), dtype=dt, device=dev)
    p["out"] = init_linear(gen, d_in, d, dtype=dt)
    return p


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv via K shifted adds. x [B,S,C], kernel [K,C];
    ``tail`` [B, K-1, C] holds the previous inputs (decode path).  Returns
    (silu(conv), the new tail)."""
    k, s = kernel.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + s] * kernel[i] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else None
    return silu(out), new_tail


def _ssd_chunked(xh, bt, ct, dt, a, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """Chunk-parallel SSD scan.

    xh [B,S,H,P], bt/ct [B,S,G,N] (G broadcasts over H), dt [B,S,H] (>0),
    a [H] (<0), all fp32.  Returns (y [B,S,H,P], h_last [B,H,N,P]).
    """
    b, s, h, p = xh.shape
    g, n = bt.shape[2], bt.shape[3]
    while s % chunk:  # halve until it divides (short prompts / odd lengths)
        chunk //= 2
    chunk = max(chunk, 1)
    nc = s // chunk
    r = h // g  # heads per B/C group: B/C are never materialized per head
    q = chunk

    # chunk-major layouts, heads split as (G, R)
    xh_c = xh.reshape(b, nc, q, g, r, p)                     # [B,C,Q,G,R,P]
    bt_c = bt.reshape(b, nc, q, g, n)                        # [B,C,Q,G,N]
    ct_c = ct.reshape(b, nc, q, g, n)
    dt_c = dt.reshape(b, nc, q, g, r)                        # [B,C,Q,G,R]
    la = dt_c * a.reshape(g, r)                              # log-decay, <0
    cum = torch.cumsum(la, dim=2)                            # [B,C,Q,G,R]
    cum_h = cum.permute(0, 1, 3, 4, 2)                       # [B,C,G,R,Q]
    dtx = dt_c[..., None] * xh_c                             # [B,C,Q,G,R,P]
    dtx_h = dtx.permute(0, 1, 3, 4, 2, 5)                    # [B,C,G,R,Q,P]

    # intra-chunk (dual attention form): M[i,j] = exp(cum_i − cum_j)·(i≥j)
    # times the per-group Gram matrix C_i·B_j, applied per head.  The
    # triangle is masked BEFORE exp: the i<j region has cum_i − cum_j > 0,
    # where exp would overflow to inf.
    gram = torch.matmul(ct_c.permute(0, 1, 3, 2, 4),
                        bt_c.permute(0, 1, 3, 4, 2))         # [B,C,G,Q,Q]
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill_(
        ~tri, float("-inf"))                                 # [B,C,G,R,Q,Q]
    if torch.is_grad_enabled() and (decay.requires_grad
                                    or gram.requires_grad):
        # training: exp saves its output for the backward, so no in-place
        # product may overwrite it (the same values as the line below)
        decay = decay.exp() * gram[:, :, :, None]
    else:
        decay.exp_().mul_(gram[:, :, :, None])
    y = torch.matmul(decay, dtx_h)                           # [B,C,G,R,Q,P]
    del decay

    # per-chunk aggregated state: S_c = Σ_t exp(cum_last − cum_t)·Δ_t·B_t xᵗ_t
    seg = torch.exp(cum_h[..., -1:] - cum_h)                 # [B,C,G,R,Q]
    wx = (seg[..., None] * dtx_h).permute(0, 1, 2, 4, 3, 5)  # [B,C,G,Q,R,P]
    state_c = torch.matmul(bt_c.permute(0, 1, 3, 4, 2),     # [B,C,G,N,Q]
                           wx.reshape(b, nc, g, q, r * p))   # [B,C,G,N,R·P]
    state_c = state_c.reshape(b, nc, g, n, r, p)
    chunk_decay = torch.exp(cum_h[..., -1])                  # [B,C,G,R]

    # inter-chunk: carry the state across chunks; h_in[c] is the state
    # entering chunk c, stored as [B,C,G,N,R,P]
    hc = (h0.reshape(b, g, r, n, p).permute(0, 1, 3, 2, 4) if h0 is not None
          else xh.new_zeros((b, g, n, r, p)))
    h_in = xh.new_empty((b, nc, g, n, r, p))
    dec = chunk_decay[:, :, :, None, :, None]                # [B,C,G,1,R,1]
    for c in range(nc):
        h_in[:, c] = hc
        hc = hc * dec[:, c] + state_c[:, c]

    # contribution of the carried state: y⁺_t = exp(cum_t)·C_t · h_in
    y_inter = torch.matmul(ct_c.permute(0, 1, 3, 2, 4),     # [B,C,G,Q,N]
                           h_in.reshape(b, nc, g, n, r * p))  # [B,C,G,Q,R·P]
    y_inter = y_inter.reshape(b, nc, g, q, r, p).permute(0, 1, 2, 4, 3, 5)
    y = y + torch.exp(cum_h)[..., None] * y_inter            # [B,C,G,R,Q,P]
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, p)
    return y, hc.permute(0, 1, 3, 2, 4).reshape(b, h, n, p)


def mamba2_block(p: Params, cfg, x: torch.Tensor, *, mode: str,
                 cache: Optional[Params] = None):
    """Full Mamba2 block. cache = {"conv_x","conv_bc": tails, "h": state}.

    Returns ``(out, new_cache)``; the new cache is None in train mode.
    ``chunked_prefill`` continues from ``cache`` (conv tails and state)."""
    if mode == "chunked_prefill" and cache is None:
        raise ValueError("chunked_prefill needs a cache")
    d_in, n, hdim, _, g, nh = _dims(cfg)
    b, s, _ = x.shape

    z = linear(p["in_z"], x)
    xr = linear(p["in_x"], x)
    bc = torch.cat([linear(p["in_b"], x), linear(p["in_c"], x)], dim=-1)
    dt = F.softplus(linear(p["in_dt"], x).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    tail_x = cache["conv_x"] if cache is not None else None
    tail_bc = cache["conv_bc"] if cache is not None else None
    xr, new_tail_x = _causal_conv(xr, p["conv_x"], tail_x)
    bc, new_tail_bc = _causal_conv(bc, p["conv_bc"], tail_bc)
    bt = bc[..., :g * n].reshape(b, s, g, n).float()
    ct = bc[..., g * n:].reshape(b, s, g, n).float()
    xh = xr.reshape(b, s, nh, hdim).float()

    if mode in ("train", "prefill", "chunked_prefill"):
        h0 = cache["h"].float() if mode == "chunked_prefill" else None
        y, h_last = _ssd_chunked(xh, bt, ct, dt, a, cfg.ssm.get("chunk", 256),
                                 h0=h0)
    elif mode == "decode":  # the exact single-step recurrence
        h_prev = cache["h"]                                   # [B,H,N,P] fp32
        dec = torch.exp(dt[:, 0] * a)                         # [B,H]
        bt0 = bt[:, 0].repeat_interleave(nh // g, dim=1)      # [B,H,N]
        ct0 = ct[:, 0].repeat_interleave(nh // g, dim=1)
        upd = (dt[:, 0, :, None, None] * bt0[..., None]
               * xh[:, 0, :, None, :])                        # [B,H,N,P]
        h_last = h_prev * dec[:, :, None, None] + upd
        y = torch.matmul(ct0[:, :, None, :], h_last)[:, None, :, 0]
    else:
        raise ValueError(f"unknown mamba2 mode {mode!r}")

    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = rms_norm_simple(y * silu(z), p["norm_g"])
    out = linear(p["out"], y)
    new_cache = None
    if mode in ("prefill", "chunked_prefill", "decode"):
        new_cache = {"conv_x": new_tail_x, "conv_bc": new_tail_bc,
                     "h": h_last.float()}
    return out, new_cache


def init_ssm_cache(cfg, batch: int, *, device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode cache: conv tails in ``compute_dtype``,
    the state fp32."""
    d_in, n, hdim, conv, g, nh = _dims(cfg)
    cdt = cfg.compute_dtype
    return {
        "conv_x": torch.zeros((batch, conv - 1, d_in), dtype=cdt,
                              device=device),
        "conv_bc": torch.zeros((batch, conv - 1, 2 * g * n), dtype=cdt,
                               device=device),
        "h": torch.zeros((batch, nh, n, hdim), dtype=torch.float32,
                         device=device),
    }


__all__ = ["init_mamba2", "init_ssm_cache", "mamba2_block"]
