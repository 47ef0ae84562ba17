"""Step builders: prefill (one-shot, or chunked window by window when the
config sets ``prefill_chunk``) and serve (one decode step), for every
family of ``models/model.py`` (dense, MoE with or without a sliding window
or MLA, SSM, hybrid, encoder-decoder).  The encoder-decoder's prefill takes
the frame embeddings and caches the encoder's cross K/V; its serve step
reads them from the cache and takes no frames.

The JAX package's ``launch/steps.py`` also builds the train step
(ROADMAP.md, module step 9e) and the jitted, sharded variants for its
dry-run (step 10); those have no port yet.  PyTorch runs eagerly, so each
``make_*_step`` returns a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _unembed_last(params, cfg: ModelConfig, hidden: torch.Tensor):
    head = params.get("lm_head", params["embed"])
    last = hidden[:, -1:]
    logits = (last @ head["table"].to(last.dtype).T).float()
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits[:, 0]


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens [B,S], enc_inputs) → (last-position logits [B,V]
    fp32, cache with capacity S); ``enc_inputs`` [B, frames, d_model] for an
    encoder-decoder, else None.  With ``cfg.prefill_chunk`` set, window by
    window (:func:`_make_chunked_prefill_step`)."""
    if cfg.prefill_chunk:
        return _make_chunked_prefill_step(cfg, cfg.prefill_chunk)

    def prefill_step(params, tokens, enc_inputs=None):
        # hidden → unembed ONLY the last position: the [B, S, V] logits
        # tensor would be 2.5 GB at batch 4 × 2048 × 151,936 in fp32
        hidden, _, cache = M.forward(params, cfg, tokens, mode="prefill",
                                     enc_inputs=enc_inputs,
                                     return_hidden=True)
        return _unembed_last(params, cfg, hidden), cache
    return prefill_step


def _make_chunked_prefill_step(cfg: ModelConfig, chunk: int):
    """Window-wise prefill: the cache is allocated at capacity S and the
    prompt runs through it ``chunk`` tokens at a time, so live activations
    are O(chunk) instead of O(S) (deepseek-v3's published path).  Not for
    encoder-decoder configs or sliding windows, as in the JAX package."""
    if cfg.family == "encdec" or cfg.encdec is not None \
            or cfg.window is not None:
        raise ValueError(f"{cfg.name}: chunked prefill takes no "
                         f"encoder-decoder and no sliding window")

    def prefill_step(params, tokens, enc_inputs=None):
        if enc_inputs is not None:
            raise ValueError("chunked prefill takes no encoder inputs")
        b, s = tokens.shape
        if s % chunk:
            raise ValueError(f"prompt length {s} is not a multiple of "
                             f"prefill_chunk {chunk}")
        cache = M.init_cache(cfg, b, s, device=tokens.device)
        ar = torch.arange(chunk, dtype=torch.int32, device=tokens.device)
        for pos0 in range(0, s, chunk):
            hidden, _, cache = M.forward(
                params, cfg, tokens[:, pos0:pos0 + chunk],
                mode="chunked_prefill", cache=cache, positions=ar + pos0,
                return_hidden=True, cursor=pos0)
        return _unembed_last(params, cfg, hidden), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, tokens [B,1], pos) → (logits [B,V],
    cache).  The cache's K/V are written in place (an encoder-decoder's
    cross K/V are only read)."""
    def serve_step(params, cache, tokens, pos):
        positions = torch.as_tensor(pos, dtype=torch.int32,
                                    device=tokens.device).reshape(1)
        logits, _, new_cache = M.forward(params, cfg, tokens, mode="decode",
                                         cache=cache, positions=positions)
        return logits[:, 0], new_cache
    return serve_step
