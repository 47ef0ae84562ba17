"""Attention: GQA (full, causal or sliding-window), MLA (DeepSeek-V3) and
cross-attention (whisper), in train, prefill, chunked-prefill and decode
modes.

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
package.

Chunked (window-wise) prefill appends a chunk of tokens at the cache
cursor, in place, and attends causally over the cache's first ``cursor +
chunk`` slots with the chunk's queries at ``q_off = cursor``: the keys
past the cursor sit at positions beyond every query of the chunk, so the
causal mask hides exactly what the JAX package's ``k_valid_len`` hides,
and the flash kernel takes the call.  The cursor is a Python int from
the step, so no layer reads ``cache["len"]`` back from the card.

MLA caches the compressed latent ``ckv`` [B, S, kv_lora_rank] and the
shared rope key ``kr`` [B, S, qk_rope_dim].  Prefill and chunked prefill
materialize per-head K (qk_nope + qk_rope = 192 wide at deepseek-v3) and V
(v_head_dim 128) from the latent and go through the flash kernel's (192,
128) instance; decode uses the absorbed matmuls in fp32, on torch ops, as
the JAX package does with no kernel.

Cross-attention (whisper's decoder) reads K/V that ``encode_cross_kv``
computes once from the encoder output and the model caches for decode; it
is non-causal and passes no ``k_valid_len``, so on the kernel route both
its prefill and its one-token decode queries launch the flash kernel over
the encoder's frames.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .layers import apply_rope, init_linear, linear, rms_norm_simple, rope_freqs
from .pjit_utils import is_dtensor

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# core chunked softmax attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, k_positions: torch.Tensor,
                      causal: bool, window: Optional[int] = None,
                      k_valid_len=None, chunk: int = 512, impl: str = "ref",
                      sm_scale: Optional[float] = None,
                      q_off: int = 0) -> torch.Tensor:
    """Softmax attention with GQA broadcast and position-based masking.

    q: [B, Sq, H, Dh]; k: [B, Sk, KV, Dh], v: [B, Sk, KV, Dv] with H % KV
    == 0 (Dv may differ from Dh: MLA).
    Masks: ``causal`` ⇒ keep k_pos ≤ q_pos;  ``window`` ⇒ also q_pos − k_pos <
    window;  ``k_valid_len`` ⇒ k index < valid length (decode caches).
    Decode over a cache (``k_valid_len`` given) takes this plain path
    whatever ``impl`` says, as in the JAX package.  The kernel route reads
    the positions as ``q_off + arange(Sq)`` and ``arange(Sk)``: a caller
    whose ``q_positions`` start elsewhere than 0 passes that start as
    ``q_off``, a Python int.
    """
    if is_dtensor(q):
        local = _local_attention(q, k, v, q_positions=q_positions,
                                 k_positions=k_positions, causal=causal,
                                 window=window, k_valid_len=k_valid_len,
                                 chunk=chunk, impl=impl, sm_scale=sm_scale,
                                 q_off=q_off)
        if local is not None:
            return local
    if impl != "ref" and k_valid_len is None:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, q_positions=q_positions,
                               k_positions=k_positions, causal=causal,
                               window=window, sm_scale=sm_scale, impl=impl,
                               q_off=q_off)
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
        # out of place: under a mesh the positions may be DTensors
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & ((qp - kp) < window)
        if k_valid_len is not None:
            mask = mask & (k_idx[None, :] < k_valid_len)
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


def kv_heads_of_shard(c: int, h: int, kv: int, m: int) -> range:
    """The kv heads that q heads ``[c·h/m, (c+1)·h/m)`` read under GQA
    (q head ``i`` reads kv head ``i // (h/kv)``), when the q heads shard
    over a `model` dim of ``m`` and the kv heads do not."""
    hl, g = h // m, h // kv
    first, last = (c * hl) // g, ((c + 1) * hl - 1) // g
    n = last - first + 1
    if hl % n or (hl < g and g % hl):
        raise ValueError(f"{h} q heads over {m} ranks do not meet {kv} kv "
                         f"heads in whole GQA groups")
    return range(first, last + 1)


def _local_attention(q, k, v, *, q_positions, k_positions, causal, window,
                     k_valid_len, chunk, impl, sm_scale, q_off):
    """Attention on DTensor q/k/v, each rank on its local shards
    (``local_map``): the flash kernel never sees a DTensor.  The batch
    shards over the batch dims and q's heads over `model`.  K/V's heads
    shard over `model` too when they divide it; otherwise (qwen3: 8 kv
    heads, `model` 16) K/V stay replicated over `model` and each rank
    takes, by its `model` coordinate, only the kv heads that its q heads
    read (:func:`kv_heads_of_shard`): no rank holds H copies of K/V.  The
    plain path over a cache (decode) goes local only when the kv heads
    shard; a head-dim-sharded cache stays with DTensor's ops (→ None), so
    that no rank gathers the cache."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.sharding import P, per_rank, placements
    from .pjit_utils import batch_axes_in_mesh

    mesh = q.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    b, h, kvh = q.shape[0], q.shape[2], k.shape[2]
    b_axes = list(batch_axes_in_mesh()
                  or [a for a in ("pod", "data") if a in sizes])
    while b_axes and b % math.prod(sizes[a] for a in b_axes):
        b_axes.pop()
    m = sizes.get("model", 1)
    model_dim = mesh.mesh_dim_names.index("model") if "model" in sizes \
        else None
    heads = ("model" if "model" in sizes and "model" not in b_axes
             and h % m == 0 else None)
    kv_ax = heads if heads and kvh % m == 0 else None
    flash = impl != "ref" and k_valid_len is None
    if not flash and heads and not kv_ax:
        return None
    q_pl = placements(P(tuple(b_axes) or None, None, heads, None), mesh)
    kv_pl = placements(P(tuple(b_axes) or None, None, kv_ax, None), mesh)
    idx = None
    if heads and not kv_ax:
        idx = per_rank(mesh, lambda c: torch.tensor(
            kv_heads_of_shard(c[model_dim], h, kvh, m), device=k.device))
    # the positions and valid length: small and replicated
    qp, kp, kvl = (t.full_tensor() if is_dtensor(t) else t
                   for t in (q_positions, k_positions, k_valid_len))

    def local(ql, kl, vl):
        if idx is not None:
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        if flash:
            return flash_attention(ql, kl, vl, causal=causal, window=window,
                                   sm_scale=sm_scale, impl=impl, q_off=q_off)
        return chunked_attention(ql, kl, vl, q_positions=qp, k_positions=kp,
                                 causal=causal, window=window,
                                 k_valid_len=kvl, chunk=chunk, impl="ref",
                                 sm_scale=sm_scale, q_off=q_off)

    # a rank's K/V gradient covers only the kv heads it took: over `model`
    # the replicated K/V's gradient is the sum of the ranks' (Partial)
    kv_grad = tuple(Partial() if idx is not None and i == model_dim else pl
                    for i, pl in enumerate(kv_pl))
    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


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


def _split_heads(y: torch.Tensor, b: int, s: int, n: int,
                 dh: int) -> torch.Tensor:
    """[B, S, n·dh] → [B, S, n, dh].  A DTensor whose columns shard over
    `model` (the rules shard the "heads" axis) keeps that shard on the
    heads when ``n`` divides `model`; otherwise the columns are gathered
    first (qwen3's 8 kv heads over 16 ranks: half a head each)."""
    from .pjit_utils import constrain_heads
    return constrain_heads(y, n).reshape(b, s, n, dh)


def gqa_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            rope: bool = True):
    b, sq, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(linear(p["wq"], x), b, sq, h, dh)
    k = _split_heads(linear(p["wk"], x), b, sq, kvh, dh)
    v = _split_heads(linear(p["wv"], x), b, sq, kvh, dh)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_g"])
        k = rms_norm_simple(k, p["k_g"])
    if rope and cfg.rope_theta is not None:
        rd = cfg.rotary_dim or dh
        cos, sin = rope_freqs(dh, cfg.rope_theta, positions, rotary_dim=rd)
        q = apply_rope(q, cos, sin, rotary_dim=rd)
        k = apply_rope(k, cos, sin, rotary_dim=rd)
    return q, k, v


def attend_cache_prefix(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, positions: torch.Tensor,
                        cursor: int, cfg,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """A chunk's queries (positions ``cursor .. cursor + Sq - 1``) over the
    cache's first ``cursor + Sq`` slots, causal, with no ``k_valid_len``:
    the JAX package's ``k_valid_len = cursor + Sq`` over the whole cache
    hides the same keys, and without it the flash kernel takes the call
    (``q_off = cursor``)."""
    n = cursor + q.shape[1]
    return chunked_attention(
        q, k_cache[:, :n], v_cache[:, :n], q_positions=positions,
        k_positions=torch.arange(n, dtype=torch.int32, device=q.device),
        causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        sm_scale=sm_scale, q_off=cursor)


def _cursor(cursor: Optional[int]) -> int:
    if not isinstance(cursor, int):
        raise ValueError("chunked_prefill needs the cache cursor as a Python "
                         f"int (tokens cached so far); got {cursor!r}")
    return cursor


def gqa_attention(p: Params, cfg, x: torch.Tensor, *, mode: str,
                  cache: Optional[Params] = None,
                  positions: Optional[torch.Tensor] = None,
                  causal: bool = True, cursor: Optional[int] = None):
    """Self-attention in train/prefill/chunked_prefill/decode modes.

    Returns ``(out, new_cache)``; cache layout {"k","v": [B, Sc, KV, Dh],
    "len": int32 scalar tensor}.  Decode writes the cache's ``k``/``v`` in
    place and returns them with ``len + 1``; chunked prefill writes the
    chunk's at ``cursor`` (a Python int, equal to ``cache["len"]``) in
    place and returns them with ``len + Sq``.
    """
    b, sq, _ = x.shape
    window = cfg.window
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=x.device)
        if mode == "chunked_prefill":
            positions = positions + _cursor(cursor)
    q, k, v = gqa_qkv(p, cfg, x, positions)

    if mode == "chunked_prefill":
        # not for ring caches, as in the JAX package
        if cache is None or window is not None:
            raise ValueError("chunked_prefill needs a cache and no sliding "
                             "window")
        pos0 = _cursor(cursor)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, pos0:pos0 + sq] = k
        v_cache[:, pos0:pos0 + sq] = v
        out = attend_cache_prefix(q, k_cache, v_cache, positions, pos0, cfg)
        out = linear(p["wo"], out.reshape(b, sq, -1))
        return out, {"k": k_cache, "v": v_cache, "len": cache["len"] + sq}

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
    # decode: sq == 1, append at the cache cursor.  Under a mesh whose
    # `model` dim the kv heads do not divide, q/k/v shard their head dim
    # as the cache does (pjit_utils)
    if cache is None:
        raise ValueError("decode mode needs a cache")
    from .pjit_utils import constrain_decode_qkv
    q, k, v = constrain_decode_qkv(q, k, v, cfg.n_kv_heads)
    pos = cache["len"]            # int32 scalar tensor: tokens cached so far
    sc = cache["k"].shape[1]
    slot = (pos % sc if window is not None else pos).reshape(1).long()
    k_cache = _write_slots(cache["k"], slot, k)
    v_cache = _write_slots(cache["v"], slot, v)
    k_pos = _cache_positions(pos, sc, window, device=x.device)
    valid = torch.clamp(pos + 1, max=sc)
    out = chunked_attention(
        q, k_cache, v_cache, q_positions=positions, k_positions=k_pos,
        causal=True, window=window, k_valid_len=valid, impl=cfg.attn_impl)
    # a head-dim-sharded output is gathered over its head dim before the
    # heads merge (DTensor cannot flatten a dim sharded inside)
    from .pjit_utils import gather_dim
    out = linear(p["wo"], gather_dim(out, -1).reshape(b, sq, -1))
    return out, {"k": k_cache, "v": v_cache, "len": pos + 1}


def _write_slots(cache: torch.Tensor, slot: torch.Tensor,
                 new: torch.Tensor) -> torch.Tensor:
    """``cache[:, slot] = new`` in place → ``cache``.  A DTensor cache is
    written through each rank's local shard, ``new`` placed as the cache
    (DTensor has no sharding rule for ``index_copy_``)."""
    if is_dtensor(cache):
        mesh = cache.device_mesh
        loc = new.to(cache.dtype)
        if is_dtensor(loc):
            loc = loc.redistribute(mesh, cache.placements).to_local()
        if is_dtensor(slot):
            slot = slot.full_tensor()
        cache.to_local().index_copy_(1, slot, loc)
        return cache
    return cache.index_copy_(1, slot, new.to(cache.dtype))


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


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------

def cross_attention(p: Params, cfg, x: torch.Tensor,
                    enc_kv: Params) -> torch.Tensor:
    """Decoder states x [B, Sq, d] attend, non-causally, to the encoder's
    precomputed K/V ({"k", "v": [B, frames, KV, Dh]}).  No ``k_valid_len``:
    on the kernel route prefill and decode (Sq = 1) both launch the flash
    kernel, as the JAX package's ``"pallas"`` route calls its kernel."""
    b, sq, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(b, sq, h, dh)
    se = enc_kv["k"].shape[1]
    out = chunked_attention(
        q, enc_kv["k"], enc_kv["v"],
        q_positions=torch.arange(sq, dtype=torch.int32, device=x.device),
        k_positions=torch.arange(se, dtype=torch.int32, device=x.device),
        causal=False, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return linear(p["wo"], out.reshape(b, sq, -1))


def encode_cross_kv(p: Params, cfg, enc_out: torch.Tensor) -> Params:
    """The cross block's K/V of the encoder output [B, frames, d]: {"k",
    "v": [B, frames, KV, Dh]}, through ``wk``/``wv`` and their biases."""
    b, se, _ = enc_out.shape
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": linear(p["wk"], enc_out).reshape(b, se, kvh, dh),
            "v": linear(p["wv"], enc_out).reshape(b, se, kvh, dh)}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg) -> Params:
    """The leaves of the JAX ``init_mla`` (seven linear weights, two norm
    gains), with the same names and layouts."""
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
    dq, dc = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    return {"wdq": init_linear(gen, d, dq, dtype=dt),
            "q_norm_g": torch.ones((dq,), dtype=dt, device=gen.device),
            "wuq": init_linear(gen, dq, h * (dn + dr), dtype=dt),
            "wdkv": init_linear(gen, d, dc, dtype=dt),
            "kv_norm_g": torch.ones((dc,), dtype=dt, device=gen.device),
            "wkr": init_linear(gen, d, dr, dtype=dt),
            "wuk": init_linear(gen, dc, h * dn, dtype=dt),
            "wuv": init_linear(gen, dc, h * dv, dtype=dt),
            "wo": init_linear(gen, h * dv, d, dtype=dt)}


def _mla_kv(p: Params, cfg, ckv: torch.Tensor, k_rope: torch.Tensor):
    """Per-head K [B, S, H, dn + dr] and V [B, S, H, dv] materialized from
    the latent ``ckv`` [B, S, dc] and the shared rope key [B, S, dr]."""
    m = cfg.mla
    b, s, _ = ckv.shape
    h, dn, dr = cfg.n_heads, m["qk_nope_dim"], m["qk_rope_dim"]
    k_nope = linear(p["wuk"], ckv).reshape(b, s, h, dn)
    v = linear(p["wuv"], ckv).reshape(b, s, h, m["v_head_dim"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    return k, v


def mla_attention(p: Params, cfg, x: torch.Tensor, *, mode: str,
                  cache: Optional[Params] = None,
                  positions: Optional[torch.Tensor] = None,
                  cursor: Optional[int] = None):
    """MLA with a compressed-latent cache and absorbed decode matmuls.

    Returns ``(out, new_cache)``; cache layout {"ckv": [B, Sc, dc], "kr":
    [B, Sc, dr], "len"}.  Decode and chunked prefill write the cache in
    place (chunked prefill at ``cursor``, a Python int).
    """
    m = cfg.mla
    b, sq, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    dc = m["kv_lora_rank"]
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=x.device)
        if mode == "chunked_prefill":
            positions = positions + _cursor(cursor)

    cq = rms_norm_simple(linear(p["wdq"], x), p["q_norm_g"])
    qall = linear(p["wuq"], cq).reshape(b, sq, h, dn + dr)
    q_nope, q_rope = qall[..., :dn], qall[..., dn:]
    ckv = rms_norm_simple(linear(p["wdkv"], x), p["kv_norm_g"])  # [B,S,dc]
    k_rope = linear(p["wkr"], x)               # [B,S,dr], shared by heads
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions, rotary_dim=dr)
    q_rope = apply_rope(q_rope, cos, sin, rotary_dim=dr)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin,
                        rotary_dim=dr)[:, :, 0]
    scale = 1.0 / math.sqrt(dn + dr)

    if mode in ("train", "prefill"):
        k, v = _mla_kv(p, cfg, ckv, k_rope)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(q, k, v, q_positions=positions,
                                k_positions=positions, causal=True,
                                impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                                sm_scale=scale)
        new_cache = None
        if mode == "prefill":
            new_cache = {"ckv": ckv, "kr": k_rope,
                         "len": torch.tensor(sq, dtype=torch.int32,
                                             device=x.device)}
        return linear(p["wo"], out.reshape(b, sq, -1)), new_cache

    if cache is None:
        raise ValueError(f"{mode} mode needs a cache")
    ckv_cache, kr_cache = cache["ckv"], cache["kr"]
    if mode == "chunked_prefill":
        # re-materialize per-head K/V over the valid slots only (the JAX
        # package does so over the whole cache; the masked slots add
        # nothing), then attend as a prefill at q_off = cursor
        pos0 = _cursor(cursor)
        n = pos0 + sq
        ckv_cache[:, pos0:n] = ckv
        kr_cache[:, pos0:n] = k_rope
        k, v = _mla_kv(p, cfg, ckv_cache[:, :n], kr_cache[:, :n])
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attend_cache_prefix(q, k, v, positions, pos0, cfg,
                                  sm_scale=scale)
        out = linear(p["wo"], out.reshape(b, sq, -1))
        return out, {"ckv": ckv_cache, "kr": kr_cache,
                     "len": cache["len"] + sq}
    if mode != "decode":
        raise ValueError(f"unknown attention mode {mode!r}")

    # decode: the absorbed matmuls in fp32 over the latent cache
    pos = cache["len"]
    slot = pos.reshape(1).long()
    ckv_cache.index_copy_(1, slot, ckv.to(ckv_cache.dtype))
    kr_cache.index_copy_(1, slot, k_rope.to(kr_cache.dtype))
    sc = ckv_cache.shape[1]
    wuk = p["wuk"]["w"].reshape(dc, h, dn).float()
    q_abs = torch.einsum("bqhn,chn->bqhc", q_nope.float(), wuk)  # [B,Sq,H,dc]
    # under a mesh: q̃ and q_rope follow the cache's latent sharding, so
    # the 32k-token latent cache is never gathered (pjit_utils)
    from .pjit_utils import constrain_last_model
    q_abs = constrain_last_model(q_abs)
    q_rope = constrain_last_model(q_rope)
    ckv_f = ckv_cache.float()
    s_nope = torch.einsum("bqhc,bsc->bhqs", q_abs, ckv_f)
    s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                          kr_cache.float())
    scores = (s_nope + s_rope) * scale
    valid = (torch.arange(sc, device=x.device)[None, None, None, :]
             <= positions[None, None, :, None])          # absolute positions
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhqs,bsc->bqhc", probs, ckv_f)
    wuv = p["wuv"]["w"].reshape(dc, h, dv).float()
    out = torch.einsum("bqhc,chv->bqhv", lat, wuv)
    out = linear(p["wo"], out.reshape(b, sq, -1).to(x.dtype))
    return out, {"ckv": ckv_cache, "kr": kr_cache, "len": pos + sq}
