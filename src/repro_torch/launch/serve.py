"""Serving driver: prefill, cache repack, then batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 2048 --gen 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu                          # small, on the host
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --device cpu --prefill-chunk 8        # window by window
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --batch 4 --prompt-len 2048  # 1500 frames

One prefill step runs the whole prompt (the flash-attention kernel on the
card; window by window through the cache when the config sets
``prefill_chunk``, as deepseek-v3's does) and builds a cache of capacity
prompt length (a sliding window's ring: ``window`` slots); the cache is
copied into a static decode cache of capacity prompt + gen (a ring and an
SSM's state carry over as they are), and a single-token serve step is
iterated.  Every architecture of
``repro_torch.configs.PORTED`` serves.  Weights are random, drawn from
``--seed``; an encoder-decoder (whisper) also gets seeded normal frame
embeddings [B, frames, d_model] for its stub frontend, which the prefill
encodes once (its cross K/V are cached; decode takes no frames).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.models import model as M
from repro_torch.launch import steps as S


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def attention_window(cfg):
    """The sliding window of the config's attention caches: ``cfg.window``,
    or the hybrid's ``hybrid["attn_window"]`` for its shared block; None
    without one."""
    return cfg.window or (cfg.hybrid or {}).get("attn_window")


def repack_cache(cache: Dict[str, Any], capacity: int, *,
                 window=None) -> Dict[str, Any]:
    """A prefill cache (capacity = prompt length) copied into a zeroed
    decode cache of ``capacity`` slots; ``len`` stays the prompt length.
    Attention stacks (``k``/``v``: [n, B, S, KV, Dh]; MLA's ``ckv``/``kr``:
    [n, B, S, width]) are padded on their sequence axis.  A stack with no
    ``len`` passes through unchanged: the SSM stack (conv tails and state)
    has no sequence axis, and an encoder-decoder's cross K/V (``cross_kv``)
    span the encoder's frames, which decode reads and never appends to
    (padded keys would take softmax weight in its non-causal attention).
    So does a ring cache of ``window`` slots (a sliding window's: decode
    writes slot ``pos % slots``, so padding would move every slot) — what
    the JAX package's ``init_cache`` does with ``min(cache_len,
    window)``."""
    out = {}
    for name, st in cache.items():
        seq = [key for key in ("k", "v", "ckv", "kr") if key in st]
        if "len" not in st or (window is not None and "k" in st
                               and st["k"].shape[2] == window):
            out[name] = st
            continue
        s = st[seq[0]].shape[2]
        if capacity < s:
            raise ValueError(f"capacity {capacity} < prompt length {s}")
        new = {}
        for key in seq:
            t = st[key]
            new[key] = t.new_zeros(t.shape[:2] + (capacity,) + t.shape[3:])
            new[key][:, :, :s] = t
        new["len"] = st["len"].clone()
        out[name] = new
    return out


def serve(params, cfg, prompts: torch.Tensor, gen: int,
          enc_inputs: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill ``prompts`` [B, P] (an encoder-decoder's with the frame
    embeddings ``enc_inputs``), repack, and decode ``gen`` greedy tokens.

    Returns the generated tokens [B, gen], the prefill logits, the last
    step's logits, the prefill cache's length and the two phases' seconds
    (each ended by a device sync)."""
    dev = prompts.device
    p = prompts.shape[1]
    prefill_step = S.make_prefill_step(cfg)
    serve_step = S.make_serve_step(cfg)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompts, enc_inputs)
    cache = repack_cache(cache, p + gen, window=attention_window(cfg))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out_tokens = []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for t in range(p, p + gen):
        out_tokens.append(tok)
        logits, cache = serve_step(params, cache, tok, t)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": logits,
            "prefill_logits": prefill_logits, "cache": cache,
            "prefill_s": t_prefill, "decode_s": t_decode}


def frame_embeddings(cfg, batch: int, gen: torch.Generator) -> torch.Tensor:
    """The stub frontend's output: seeded normal frames [batch, frames,
    d_model] in ``cfg.compute_dtype`` on the generator's device (the JAX
    serve driver's ``enc``)."""
    shape = (batch, cfg.encdec["enc_frames"], cfg.d_model)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(cfg.compute_dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill window by window, this many tokens at a "
                    "time (default: the config's prefill_chunk)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(remat="none")
    if args.prefill_chunk is not None:
        cfg = cfg.replace(prefill_chunk=args.prefill_chunk or None)
    gen = M.make_generator(args.seed, args.device)
    dev = gen.device
    params = M.init(gen, cfg)
    b, p, g = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev,
                            dtype=torch.int32)
    enc = (frame_embeddings(cfg, b, gen) if cfg.family == "encdec"
           else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = serve(params, cfg, prompts, g, enc)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    gen_ids = res["tokens"].cpu()
    print(f"[serve] batch={b} prefill({p} tok)={t_prefill:.2f}s "
          f"decode {g} tok in {t_decode:.2f}s "
          f"({1000 * t_decode / g:.1f} ms/tok/batch)")
    print(f"[serve] sample generated ids: {gen_ids[0][:16].tolist()}")
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
            if dev.type == "cuda" else "not measured (cpu)")
    print(f"[serve] peak device memory {peak}")
    assert gen_ids.shape == (b, g) and bool(torch.isfinite(res["logits"]).all())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
