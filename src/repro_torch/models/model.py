"""Model assembly for the ``dense`` family (attention + MLP decoder layers).

Public entry points, as in the JAX package:
  * ``init(gen, cfg)``                 → params
  * ``forward(params, cfg, tokens, mode, cache, positions)``
  * ``init_cache(cfg, batch, cache_len, device=...)``

The JAX package stacks the layers' parameters on a leading axis and scans
over them; here ``params["dense_stack"]`` is a list of per-layer dicts and
the stack is a Python loop.  Caches keep the JAX layout, stacked on the
layer axis: ``{"dense_stack": {"k", "v": [L, B, Sc, KV, Dh], "len": [L]}}``.
The JAX package's sharding constraints (``models/pjit_utils.py``) are hints
to XLA's partitioner with no meaning on one card, so they are left out.
Other families (MoE, SSM, hybrid, encoder-decoder) and MLA raise: they are
not ported yet (ROADMAP.md, module step 9).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core.assoc_tensor import resolve_device
from . import attention as attn
from .layers import (Params, apply_mlp, apply_norm, embed, init_embedding,
                     init_mlp, init_norm)


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """The seeded generator that :func:`init` draws from, on ``device``
    (``"cuda"`` without a card raises)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _check_ported(cfg) -> None:
    if (cfg.family != "dense" or cfg.moe or cfg.mla or cfg.mtp
            or cfg.pos_emb != "rope"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with RoPE and without MoE, "
            f"MLA or MTP is ported (ROADMAP.md, module step 9)")


def _residual_scale(cfg) -> float:
    if cfg.scale_depth is None:
        return 1.0
    return cfg.scale_depth / math.sqrt(cfg.n_layers)


def init_decoder_layer(gen, cfg) -> Params:
    dt, dev = cfg.param_dtype, gen.device
    return {"attn_norm": init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                   device=dev),
            "attn": attn.init_gqa(gen, cfg),
            "mlp_norm": init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                  device=dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                            dtype=dt, bias=cfg.attn_bias)}


def apply_decoder_layer(p: Params, cfg, x, *, mode: str, cache, positions,
                        causal: bool = True):
    rs = _residual_scale(cfg)
    h = apply_norm(p["attn_norm"], x, kind=cfg.norm)
    a_out, new_cache = attn.gqa_attention(p["attn"], cfg, h, mode=mode,
                                          cache=cache, positions=positions,
                                          causal=causal)
    x = (x + a_out * rs).to(cfg.compute_dtype)
    h = apply_norm(p["mlp_norm"], x, kind=cfg.norm)
    x = (x + apply_mlp(p["mlp"], h, act=cfg.act) * rs).to(cfg.compute_dtype)
    return x, new_cache


def init(gen: torch.Generator, cfg) -> Params:
    """Seeded random parameters on the generator's device."""
    _check_ported(cfg)
    dt, dev = cfg.param_dtype, gen.device
    p: Params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                         dtype=dt)}
    p["final_norm"] = init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(gen, cfg.vocab, cfg.d_model, dtype=dt)
    p["dense_stack"] = [init_decoder_layer(gen, cfg)
                        for _ in range(cfg.n_layers)]
    return p


def forward(params: Params, cfg, tokens: torch.Tensor, *, mode: str = "train",
            cache: Optional[Params] = None,
            positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """tokens [B,S] int → ``(logits [B,S,V] fp32 or hidden, aux, cache)``.

    decode mode: S==1, ``cache`` required, ``positions`` = [1] current pos;
    the cache's ``k``/``v`` are updated in place.
    """
    _check_ported(cfg)
    x = embed(params["embed"], tokens, scale=cfg.scale_emb).to(cfg.compute_dtype)
    sq = tokens.shape[1]
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=tokens.device)
    stack = params["dense_stack"]
    st = cache["dense_stack"] if cache is not None else None
    k_all = v_all = None
    lens = []
    for i, lp in enumerate(stack):
        cl = None if st is None else {"k": st["k"][i], "v": st["v"][i],
                                      "len": st["len"][i]}
        x, nc = apply_decoder_layer(lp, cfg, x, mode=mode, cache=cl,
                                    positions=positions)
        if mode == "prefill":     # one [L, ...] cache, filled layer by layer
            if k_all is None:
                k_all = nc["k"].new_empty((len(stack),) + nc["k"].shape)
                v_all = nc["v"].new_empty((len(stack),) + nc["v"].shape)
            k_all[i], v_all[i] = nc["k"], nc["v"]
        if mode in ("prefill", "decode"):
            lens.append(nc["len"])
    new_cache = None
    if mode == "decode":          # st["k"], st["v"] were written in place
        new_cache = {"dense_stack": {"k": st["k"], "v": st["v"],
                                     "len": torch.stack(lens)}}
    elif mode == "prefill":
        new_cache = {"dense_stack": {"k": k_all, "v": v_all,
                                     "len": torch.stack(lens)}}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    x = apply_norm(params["final_norm"], x, kind=cfg.norm)
    if return_hidden:
        return x, aux, new_cache
    head = params.get("lm_head", params["embed"])
    logits = (x @ head["table"].to(x.dtype).T).float()
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits, aux, new_cache


def init_cache(cfg, batch: int, cache_len: int, *, device="cuda") -> Params:
    """Static-shape decode caches, stacked on the layer axis."""
    _check_ported(cfg)
    if cfg.window is not None:
        raise NotImplementedError("sliding-window ring caches are not ported "
                                  "yet (ROADMAP.md, module step 9)")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.dh)
    return {"dense_stack": {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "len": torch.zeros((cfg.n_layers,), dtype=torch.int32, device=dev)}}


def param_count(params: Params) -> int:
    """Number of parameter elements (tied embeddings counted once)."""
    def walk(t: Any) -> int:
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        return sum(walk(v) for v in t)
    return walk(params)


__all__ = ["apply_decoder_layer", "forward", "init", "init_cache",
           "init_decoder_layer", "make_generator", "param_count"]
