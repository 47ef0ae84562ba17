"""GQA self-attention (full or causal) in train, prefill and decode modes.

All softmax attention flows through :func:`chunked_attention`.  With
``impl="ref"`` it is the plain query-chunked path (peak live buffer
``[B, H, Qc, Sk]``), the JAX package's ``"reference"``; with ``"auto"`` or
``"cuda"`` it calls the flash-attention wrapper
(:mod:`repro_torch.kernels.flash_attention`), which launches the CUDA
kernel on CUDA tensors (``"auto"`` runs the kernel's plain version on CPU
tensors), as the JAX package's ``"pallas"`` does on a TPU.

Decode writes K/V at the cache cursor into a static-shape cache in place
(the JAX package returns a new cache and donates the old one; the port
saves the copy).  With a sliding window (``cfg.window``) the cache is a
ring of ``window`` slots: a prefill keeps the last ``min(window, S)``
tokens, position ``pos`` in slot ``pos % window`` (the slots not written
stay zero), and decode writes slot ``pos % window``, as in the JAX
package.  Chunked prefill, cross-attention and MLA are not ported yet
(ROADMAP.md, module step 9).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .layers import apply_rope, init_linear, linear, rms_norm_simple, rope_freqs

Params = Dict[str, Any]
_TODO = "not ported yet (ROADMAP.md, module step 9)"


# ---------------------------------------------------------------------------
# core chunked softmax attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, k_positions: torch.Tensor,
                      causal: bool, window: Optional[int] = None,
                      k_valid_len=None, chunk: int = 512, impl: str = "ref",
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with GQA broadcast and position-based masking.

    q: [B, Sq, H, Dh]; k/v: [B, Sk, KV, Dh] with H % KV == 0.
    Masks: ``causal`` ⇒ keep k_pos ≤ q_pos;  ``window`` ⇒ also q_pos − k_pos <
    window;  ``k_valid_len`` ⇒ k index < valid length (decode caches).
    Decode over a cache (``k_valid_len`` given) takes this plain path
    whatever ``impl`` says, as in the JAX package.
    """
    if impl != "ref" and k_valid_len is None:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, q_positions=q_positions,
                               k_positions=k_positions, causal=causal,
                               window=window, sm_scale=sm_scale, impl=impl)
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kv, g, dh)
    kf, vf = k.float(), v.float()
    k_idx = torch.arange(k.shape[1], device=q.device)

    def one_chunk(qc, qpos_c):
        # qc: [B, Qc, KV, G, Dh] → scores [B, KV, G, Qc, Sk], fp32
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * scale
        qp = qpos_c[:, None]
        kp = k_positions[None, :]
        mask = torch.ones((qc.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= (qp - kp) < window
        if k_valid_len is not None:
            mask &= k_idx[None, :] < k_valid_len
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)       # fully-masked rows
        out_c = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), vf)
        return out_c.to(qc.dtype)

    dv = v.shape[-1]
    if sq % chunk != 0:
        chunk = sq                    # non-divisible: one block
    if sq <= chunk:
        out = one_chunk(qg, q_positions)
    else:
        out = torch.cat([one_chunk(qg[:, i:i + chunk],
                                   q_positions[i:i + chunk])
                         for i in range(0, sq, chunk)], dim=1)
    return out.reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg) -> Params:
    d = cfg.d_model
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt, bias = cfg.param_dtype, cfg.attn_bias
    p = {"wq": init_linear(gen, d, h * dh, dtype=dt, bias=bias),
         "wk": init_linear(gen, d, kvh * dh, dtype=dt, bias=bias),
         "wv": init_linear(gen, d, kvh * dh, dtype=dt, bias=bias),
         "wo": init_linear(gen, h * dh, d, dtype=dt, bias=bias)}
    if cfg.qk_norm:
        p["q_g"] = torch.ones((dh,), dtype=dt, device=gen.device)
        p["k_g"] = torch.ones((dh,), dtype=dt, device=gen.device)
    return p


def gqa_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            rope: bool = True):
    b, sq, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(b, sq, h, dh)
    k = linear(p["wk"], x).reshape(b, sq, kvh, dh)
    v = linear(p["wv"], x).reshape(b, sq, kvh, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_g"])
        k = rms_norm_simple(k, p["k_g"])
    if rope and cfg.rope_theta is not None:
        rd = cfg.rotary_dim or dh
        cos, sin = rope_freqs(dh, cfg.rope_theta, positions, rotary_dim=rd)
        q = apply_rope(q, cos, sin, rotary_dim=rd)
        k = apply_rope(k, cos, sin, rotary_dim=rd)
    return q, k, v


def gqa_attention(p: Params, cfg, x: torch.Tensor, *, mode: str,
                  cache: Optional[Params] = None,
                  positions: Optional[torch.Tensor] = None,
                  causal: bool = True):
    """Self-attention in train/prefill/decode modes.

    Returns ``(out, new_cache)``; cache layout {"k","v": [B, Sc, KV, Dh],
    "len": int32 scalar tensor}.  Decode writes the cache's ``k``/``v`` in
    place and returns them with ``len + 1``.
    """
    b, sq, _ = x.shape
    window = cfg.window
    if mode == "chunked_prefill":
        raise NotImplementedError(f"chunked prefill is {_TODO}")
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=x.device)
    q, k, v = gqa_qkv(p, cfg, x, positions)

    if mode in ("train", "prefill"):
        out = chunked_attention(
            q, k, v, q_positions=positions, k_positions=positions,
            causal=causal, window=window, impl=cfg.attn_impl,
            chunk=cfg.attn_chunk)
        new_cache = None
        if mode == "prefill":
            if window is not None:
                k, v = _ring(k, window), _ring(v, window)
            new_cache = {"k": k, "v": v,
                         "len": torch.tensor(sq, dtype=torch.int32,
                                             device=x.device)}
        return linear(p["wo"], out.reshape(b, sq, -1)), new_cache

    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")
    # decode: sq == 1, append at the cache cursor.  The JAX package pins
    # q/k/v shardings here (pjit_utils); one card has nothing to pin.
    if cache is None:
        raise ValueError("decode mode needs a cache")
    pos = cache["len"]            # int32 scalar tensor: tokens cached so far
    sc = cache["k"].shape[1]
    slot = (pos % sc if window is not None else pos).reshape(1).long()
    k_cache = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    k_pos = _cache_positions(pos, sc, window, device=x.device)
    valid = torch.clamp(pos + 1, max=sc)
    out = chunked_attention(
        q, k_cache, v_cache, q_positions=positions, k_positions=k_pos,
        causal=True, window=window, k_valid_len=valid, impl=cfg.attn_impl)
    out = linear(p["wo"], out.reshape(b, sq, -1))
    return out, {"k": k_cache, "v": v_cache, "len": pos + 1}


def _ring(t: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's K or V [B, S, KV, Dh] as a ring cache of ``window``
    slots: the last ``min(window, S)`` tokens, position ``pos`` in slot
    ``pos % window``, zeros in the slots not written."""
    sq = t.shape[1]
    cap = min(window, sq)
    slots = (torch.arange(cap, device=t.device) + (sq - cap)) % window
    ring = t.new_zeros((t.shape[0], window) + t.shape[2:])
    return ring.index_copy_(1, slots, t[:, sq - cap:])


def _cache_positions(pos, cache_size: int, window: Optional[int], *,
                     device=None) -> torch.Tensor:
    """Absolute positions of each cache slot (ring-aware)."""
    idx = torch.arange(cache_size, dtype=torch.int32, device=device)
    if window is None:
        return idx
    # slot s holds the most recent token t with t % cache_size == s, t ≤ pos
    cur_slot = pos % cache_size
    age = (cur_slot - idx) % cache_size
    return pos - age


def cross_attention(*args, **kw):
    raise NotImplementedError(f"cross-attention (whisper) is {_TODO}")


def encode_cross_kv(*args, **kw):
    raise NotImplementedError(f"cross-attention (whisper) is {_TODO}")


def init_mla(*args, **kw):
    raise NotImplementedError(f"MLA (deepseek-v3) is {_TODO}")


def mla_attention(*args, **kw):
    raise NotImplementedError(f"MLA (deepseek-v3) is {_TODO}")
