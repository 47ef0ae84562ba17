"""Model assembly for the ``dense``, ``moe``, ``ssm``, ``hybrid`` and
``encdec`` families.

Public entry points, as in the JAX package:
  * ``init(gen, cfg)``                 → params
  * ``forward(params, cfg, tokens, mode, cache, positions, enc_inputs)``
  * ``lm_loss(params, cfg, batch)``    → scalar + metrics
  * ``init_cache(cfg, batch, cache_len, device=...)``

The JAX package stacks the layers' parameters on a leading axis and scans
over them; here ``params["dense_stack"]``, ``params["moe_stack"]`` and
``params["mamba_stack"]`` are lists of per-layer dicts and the stack is a
Python loop.  A ``moe`` config runs its ``first_dense`` leading layers from
``dense_stack`` and the rest, attention + MoE (``models/moe.py``), from
``moe_stack``; ``forward``'s ``aux`` is the sum of their load-balancing
losses.  The hybrid (zamba2) keeps one ``shared`` attention+MLP block,
invoked before every ``attn_every``-th mamba layer, and its LoRA factors
stacked on the invocation axis (``shared_lora["a"]``: [n_inv, d, r],
``["b"]``: [n_inv, r, H·Dh]), as in the JAX package.  The encoder-decoder
(whisper) keeps ``enc_stack`` (bidirectional self-attention + MLP layers
over the frame embeddings plus the sinusoidal ``enc_pos``, then
``enc_norm``) and ``dec_stack`` (causal self-attention, cross-attention
to the encoder output through each layer's ``cross`` block, MLP); the
decoder adds learned positions (``params["pos"]``, [max_seq, d]).  Caches
keep the JAX layout, stacked on the layer (or invocation) axis:

  * dense/moe: ``{"dense_stack"|"moe_stack": {"k", "v": [L, B, Sc, KV,
    Dh], "len": [L]}}``; with MLA (deepseek-v3) ``{"ckv": [L, B, Sc,
    kv_lora_rank], "kr": [L, B, Sc, qk_rope_dim], "len": [L]}``;
  * ssm: ``{"mamba_stack": {"conv_x": [L, B, K-1, d_inner], "conv_bc":
    [L, B, K-1, 2·G·N], "h": [L, B, H, N, P] fp32}}``;
  * hybrid: the ssm cache plus ``"shared_attn": {"k", "v": [n_inv, B, Sc,
    KV, Dh], "len": [n_inv]}``;
  * encdec: ``{"dec_stack": {"k", "v", "len"}, "cross_kv": {"k", "v": [L,
    B, frames, KV, Dh]}}``: a prefill runs the encoder once and caches each
    decoder layer's cross K/V, which decode reads and never writes.

With a sliding window (``cfg.window``, or the hybrid's
``hybrid["attn_window"]`` for its shared block) each attention cache is a
ring of ``Sc = min(cache_len, window)`` slots (``models/attention.py``).
Decode and chunked prefill write every cache tensor in place and return
the same dict; a chunked prefill (``mode="chunked_prefill"``) appends a
window of tokens at the cache cursor, which the step passes as the Python
int ``cursor``.  A config with ``mla`` attends with MLA
(``attention.mla_attention``) in every layer; with ``mtp`` the parameters
hold DeepSeek-V3's multi-token-prediction block (``params["mtp"]``: the
norms ``norm_h`` and ``norm_e``, ``proj`` [2·d, d] and one dense
``layer``), which only the training loss runs, so serving never reads it.
The JAX package's sharding constraints stand at the same places
(``models/pjit_utils.py``): the embedding output, each layer's input and
output (the residual stream batch-sharded, or sequence-sharded with
``cfg.seq_parallel``) and each loss chunk's hidden states.  They act on
DTensors under an active mesh (``launch.steps.build_sharded``) and return
anything else as it is.  Sinusoidal decoder positions (``pos_emb="sinusoidal"``, in no
shipped config) raise.

Training: ``lm_loss`` is the sequence-chunked cross-entropy of the hidden
states against the labels (``chunked_lm_loss``: the [B, S, V] logits are
never whole), plus deepseek-v3's MTP loss (``_mtp_loss``) and the MoE
load-balancing loss, each with its config weight.  With ``cfg.remat ==
"full"`` a train-mode forward under autograd checkpoints every layer
(``torch.utils.checkpoint``, non-reentrant: only each layer's input is
kept and the layer runs again in the backward), as the JAX package's
``jax.checkpoint`` of its scan body does, and ``chunked_lm_loss``
checkpoints each sequence chunk when ``cfg.remat != "none"``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.assoc_tensor import resolve_device
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .pjit_utils import (constrain_batch, constrain_seq, fsdp_gather,
                         gather_dim, is_dtensor)
from .layers import (Params, _normal, apply_mlp, apply_norm, embed,
                     init_embedding, init_mlp, init_norm, sharded_matmul,
                     sinusoidal_positions)

# the loss's sequence chunks and every layer's recompute checkpoint with
# the non-reentrant implementation (autograd's saved-tensor hooks)
_checkpoint = functools.partial(checkpoint, use_reentrant=False)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
POS_EMBS = ("rope", "learned")
# the modes that write the caller's cache in place
_IN_PLACE = ("decode", "chunked_prefill")


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """The seeded generator that :func:`init` draws from, on ``device``
    (``"cuda"`` without a card raises)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _check_ported(cfg) -> None:
    if cfg.family not in FAMILIES or cfg.pos_emb not in POS_EMBS:
        raise NotImplementedError(
            f"{cfg.name}: only the {'/'.join(FAMILIES)} families with "
            f"{' or '.join(POS_EMBS)} positions are ported (ROADMAP.md, "
            f"module step 9)")


def n_invocations(cfg) -> int:
    """How often the hybrid's shared block runs: before layers 0, k, 2k..."""
    every = cfg.hybrid["attn_every"]
    return (cfg.n_layers + every - 1) // every


def _residual_scale(cfg) -> float:
    if cfg.scale_depth is None:
        return 1.0
    return cfg.scale_depth / math.sqrt(cfg.n_layers)


def init_decoder_layer(gen, cfg, *, use_moe: bool = False,
                       cross: bool = False) -> Params:
    """Attention, with ``cross`` a cross-attention block (whisper's
    decoder), then an MLP or MoE; drawn in the JAX init's order."""
    dt, dev = cfg.param_dtype, gen.device
    p = {"attn_norm": init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                device=dev),
         "attn": (attn.init_mla(gen, cfg) if cfg.mla
                  else attn.init_gqa(gen, cfg))}
    if cross:
        p["cross_norm"] = init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                    device=dev)
        p["cross"] = attn.init_gqa(gen, cfg)
    p["mlp_norm"] = init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                              device=dev)
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                            dtype=dt, bias=cfg.attn_bias)
    return p


def apply_decoder_layer(p: Params, cfg, x, *, mode: str, cache, positions,
                        use_moe: bool = False, causal: bool = True,
                        cursor: Optional[int] = None, enc_kv=None):
    """→ ``(x, new_cache, aux, load)``: ``aux`` the MoE layer's
    load-balancing loss and ``load`` its expert load (0.0 and None for an
    MLP layer).  ``cursor``: chunked prefill's tokens cached so far.
    ``enc_kv``: the encoder's cross K/V for this layer, attended to between
    the self-attention and the MLP."""
    rs = _residual_scale(cfg)
    h = apply_norm(p["attn_norm"], x, kind=cfg.norm)
    if cfg.mla:
        a_out, new_cache = attn.mla_attention(p["attn"], cfg, h, mode=mode,
                                              cache=cache, positions=positions,
                                              cursor=cursor)
    else:
        a_out, new_cache = attn.gqa_attention(p["attn"], cfg, h, mode=mode,
                                              cache=cache, positions=positions,
                                              causal=causal, cursor=cursor)
    x = (x + a_out * rs).to(cfg.compute_dtype)
    if enc_kv is not None:
        h = apply_norm(p["cross_norm"], x, kind=cfg.norm)
        x = (x + attn.cross_attention(p["cross"], cfg, h, enc_kv) * rs
             ).to(cfg.compute_dtype)
    h = apply_norm(p["mlp_norm"], x, kind=cfg.norm)
    if use_moe:
        m_out, aux, load = moe_lib.apply_moe(p["moe"], cfg, h)
    else:
        m_out, aux, load = apply_mlp(p["mlp"], h, act=cfg.act), 0.0, None
    x = (x + m_out * rs).to(cfg.compute_dtype)
    return x, new_cache, aux, load


def init_mamba_layer(gen, cfg) -> Params:
    return {"norm": init_norm(cfg.d_model, kind=cfg.norm,
                              dtype=cfg.param_dtype, device=gen.device),
            "mixer": ssm_lib.init_mamba2(gen, cfg)}


def apply_mamba_layer(p: Params, cfg, x, *, mode: str, cache):
    h = apply_norm(p["norm"], x, kind=cfg.norm)
    out, new_cache = ssm_lib.mamba2_block(p["mixer"], cfg, h, mode=mode,
                                          cache=cache)
    return (x + out).to(cfg.compute_dtype), new_cache


def _n_dense(cfg) -> int:
    """The leading MLP layers: all of a dense config's, a moe config's
    ``first_dense``."""
    return cfg.moe.get("first_dense", 0) if cfg.moe else cfg.n_layers


def init(gen: torch.Generator, cfg) -> Params:
    """Seeded random parameters on the generator's device."""
    _check_ported(cfg)
    dt, dev = cfg.param_dtype, gen.device
    p: Params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                         dtype=dt)}
    if cfg.pos_emb == "learned":
        p["pos"] = _normal(gen, (cfg.max_seq, cfg.d_model), 0.02, dt)
    p["final_norm"] = init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(gen, cfg.vocab, cfg.d_model, dtype=dt)
    if cfg.family in ("dense", "moe"):
        n_dense = _n_dense(cfg)
        if n_dense:
            p["dense_stack"] = [init_decoder_layer(gen, cfg)
                                for _ in range(n_dense)]
        if cfg.n_layers > n_dense:
            p["moe_stack"] = [init_decoder_layer(gen, cfg, use_moe=True)
                              for _ in range(cfg.n_layers - n_dense)]
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction block: one extra block
            # over proj([norm(h); norm(emb(t+1))]) predicting t+2
            d = cfg.d_model
            p["mtp"] = {
                "norm_h": init_norm(d, kind=cfg.norm, dtype=dt, device=dev),
                "norm_e": init_norm(d, kind=cfg.norm, dtype=dt, device=dev),
                "proj": _normal(gen, (2 * d, d), (2 * d) ** -0.5, dt),
                "layer": init_decoder_layer(gen, cfg)}
        return p
    if cfg.family == "encdec":
        p["enc_stack"] = [init_decoder_layer(gen, cfg)
                          for _ in range(cfg.encdec["enc_layers"])]
        p["dec_stack"] = [init_decoder_layer(gen, cfg, cross=True)
                          for _ in range(cfg.n_layers)]
        p["enc_norm"] = init_norm(cfg.d_model, kind=cfg.norm, dtype=dt,
                                  device=dev)
        p["enc_pos"] = sinusoidal_positions(cfg.encdec["enc_frames"],
                                            cfg.d_model, device=dev).to(dt)
        return p
    p["mamba_stack"] = [init_mamba_layer(gen, cfg)
                        for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        # one shared attention+MLP block, and a LoRA delta on its wq per
        # invocation (b starts at zero, as in the JAX package)
        p["shared"] = init_decoder_layer(gen, cfg)
        r = cfg.hybrid.get("lora_rank", 0)
        if r:
            n_inv = n_invocations(cfg)
            p["shared_lora"] = {
                "a": _normal(gen, (n_inv, cfg.d_model, r), 0.01, dt),
                "b": torch.zeros((n_inv, r, cfg.n_heads * cfg.dh), dtype=dt,
                                 device=dev)}
    return p


class _Stack:
    """A cache stacked on a leading axis, read slot by slot.  Prefill fills
    a new stack as slots come; decode and chunked prefill write the given
    stack in place."""

    def __init__(self, st, n: int, mode: str):
        self.st, self.n, self.mode = st, n, mode
        self.new: dict = {}
        self.lens: list = []

    def slot(self, i: int):
        if self.st is None:
            return None
        return {key: t[i] for key, t in self.st.items()}

    def put(self, i: int, nc) -> None:
        for key, t in nc.items():
            if key == "len":
                self.lens.append(t)
            elif self.mode in _IN_PLACE:     # attention wrote its view
                if t.data_ptr() != self.st[key][i].data_ptr():
                    self.st[key][i].copy_(t)
            else:
                if key not in self.new:
                    self.new[key] = t.new_empty((self.n,) + t.shape)
                self.new[key][i] = t

    def result(self):
        out = dict(self.st if self.mode in _IN_PLACE else self.new)
        if self.lens:
            out["len"] = torch.stack(self.lens)
        return out


def forward(params: Params, cfg, tokens: torch.Tensor, *, mode: str = "train",
            cache: Optional[Params] = None,
            positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False, cursor: Optional[int] = None,
            enc_inputs: Optional[torch.Tensor] = None):
    """tokens [B,S] int → ``(logits [B,S,V] fp32 or hidden, aux, cache)``.

    decode mode: S==1, ``cache`` required, ``positions`` = [1] current pos;
    every tensor of the cache is updated in place.  chunked_prefill mode:
    ``cache`` required (capacity for every window), ``positions`` =
    ``cursor + arange(S)``; the window is appended at ``cursor``, the
    tokens cached so far as a Python int, which the step knows, so that no
    layer reads the cache's ``len`` back from the device.  encdec:
    ``enc_inputs`` [B, frames, d_model] (the stub frontend's frame
    embeddings) in train and prefill; decode reads the cached cross K/V.
    """
    _check_ported(cfg)
    if mode not in ("train", "prefill", "chunked_prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "chunked_prefill" and (cache is None
                                      or not isinstance(cursor, int)):
        raise ValueError("chunked_prefill needs a cache and the cursor as a "
                         f"Python int; got cursor {cursor!r}")
    x = embed(params["embed"], tokens, scale=cfg.scale_emb).to(cfg.compute_dtype)
    x = constrain_batch(x)
    sq = tokens.shape[1]
    if positions is None:
        positions = torch.arange(sq, dtype=torch.int32, device=tokens.device)
        if mode == "chunked_prefill":
            positions = positions + cursor
    if cfg.pos_emb == "learned":
        x = x + (params["pos"][positions][None] if mode in _IN_PLACE
                 else params["pos"][:sq][None])
    if cfg.family == "encdec":
        x, aux, new_cache = _encdec_forward(params, cfg, x, mode=mode,
                                            cache=cache, positions=positions,
                                            enc_inputs=enc_inputs)
    else:
        fwd = (_dense_forward if cfg.family in ("dense", "moe")
               else _mamba_forward)
        x, aux, new_cache = fwd(params, cfg, x, mode=mode, cache=cache,
                                positions=positions, cursor=cursor)

    x = apply_norm(params["final_norm"], x, kind=cfg.norm)
    if return_hidden:
        return x, aux, new_cache
    head = params.get("lm_head", params["embed"])
    logits = (x @ head["table"].to(x.dtype).T).float()
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits, aux, new_cache


def _remat(cfg, mode: str) -> bool:
    """Checkpoint each layer: a train-mode forward under autograd with
    ``remat == "full"`` (the JAX package checkpoints its scan body)."""
    return mode == "train" and cfg.remat == "full" \
        and torch.is_grad_enabled()


def _run(layer, x, remat: bool, cfg=None):
    """``layer(x)``, checkpointed when ``remat``; with ``cfg`` the residual
    stream is pinned batch- (or sequence-) sharded before and after the
    layer, as the JAX package's scan body pins it."""
    if cfg is None:
        return _checkpoint(layer, x) if remat else layer(x)
    pin = constrain_seq if cfg.seq_parallel else constrain_batch
    out = _checkpoint(layer, pin(x)) if remat else layer(pin(x))
    return (pin(out[0]),) + tuple(out[1:])


def _dense_forward(params, cfg, x, *, mode, cache, positions, cursor):
    """The ``dense_stack`` (MLP layers), then the ``moe_stack`` (MoE
    layers); the sum of the layers' aux losses."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    remat = _remat(cfg, mode)
    for name, use_moe in (("dense_stack", False), ("moe_stack", True)):
        if name not in params:
            continue
        stack = params[name]
        st = _Stack(cache[name] if cache is not None else None, len(stack),
                    mode)
        for i, lp in enumerate(stack):
            layer = functools.partial(
                apply_decoder_layer, lp, cfg, mode=mode, cache=st.slot(i),
                positions=positions, use_moe=use_moe, cursor=cursor)
            x, nc, a, _ = _run(layer, x, remat, cfg)
            if use_moe:
                aux = aux + a
            if mode != "train":
                st.put(i, nc)
        if mode != "train":
            new_cache[name] = st.result()
    return x, aux, (new_cache if mode != "train" else None)


def _mamba_forward(params, cfg, x, *, mode, cache, positions, cursor):
    """The ssm stack, and for the hybrid (zamba2) the shared block before
    every ``attn_every``-th layer: ``idx % attn_every == 0``, invocation
    ``idx // attn_every`` with its own LoRA delta and cache slot."""
    stack = params["mamba_stack"]
    hybrid = cfg.family == "hybrid"
    ms = _Stack(cache["mamba_stack"] if cache is not None else None,
                len(stack), mode)
    if hybrid:
        window = cfg.hybrid.get("attn_window")
        hy_cfg = cfg.replace(window=window) if window else cfg
        every = cfg.hybrid["attn_every"]
        shared, lora = params["shared"], params.get("shared_lora")
        shared_st = _Stack(cache["shared_attn"] if cache is not None
                           else None, n_invocations(cfg), mode)
    remat = _remat(cfg, mode)
    for i, lp in enumerate(stack):
        def layer(x, i=i, lp=lp):
            # the shared block before the mamba layer it precedes: one
            # checkpointed body, as the JAX package's scan step
            nac = None
            if hybrid and i % every == 0:
                inv = i // every
                pa = (shared if lora is None
                      else _apply_lora_to_attn(shared, lora, inv))
                x, nac, _, _ = apply_decoder_layer(
                    pa, hy_cfg, x, mode=mode, cache=shared_st.slot(inv),
                    positions=positions, cursor=cursor)
            x, nc = apply_mamba_layer(lp, cfg, x, mode=mode,
                                      cache=ms.slot(i))
            return x, nac, nc
        x, nac, nc = _run(layer, x, remat, cfg)
        if mode != "train":
            if nac is not None:
                shared_st.put(i // every, nac)
            ms.put(i, nc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE
    if mode == "train":
        return x, aux, None
    new_cache = {"mamba_stack": ms.result()}
    if hybrid:
        new_cache["shared_attn"] = shared_st.result()
    return x, aux, new_cache


def _encode(params: Params, cfg, enc_inputs: torch.Tensor,
            mode: str) -> Params:
    """The encoder over the frame embeddings [B, frames, d] (plus
    ``enc_pos``; bidirectional layers, then ``enc_norm``), and each decoder
    layer's cross K/V of its output, stacked: {"k", "v": [L, B, frames,
    KV, Dh]}.  ``mode`` is the caller's (train checkpoints the layers)."""
    e = enc_inputs.to(cfg.compute_dtype) + params["enc_pos"][None]
    pos = torch.arange(e.shape[1], dtype=torch.int32, device=e.device)
    remat = _remat(cfg, mode)
    for lp in params["enc_stack"]:
        e, _, _, _ = _run(functools.partial(
            apply_decoder_layer, lp, cfg, mode="train", cache=None,
            positions=pos, causal=False), e, remat, cfg)
    e = apply_norm(params["enc_norm"], e, kind=cfg.norm)
    kvs = [attn.encode_cross_kv(lp["cross"], cfg, e)
           for lp in params["dec_stack"]]
    return {key: torch.stack([kv[key] for kv in kvs]) for key in ("k", "v")}


def _encdec_forward(params, cfg, x, *, mode, cache, positions, enc_inputs):
    """whisper: train and prefill run the encoder (:func:`_encode`), decode
    reads ``cache["cross_kv"]``; then the decoder stack, each layer
    attending to its own cross K/V.  The cache: the decoder's self-attention
    stack and the cross K/V."""
    if mode == "chunked_prefill":
        raise ValueError(f"{cfg.name}: chunked prefill takes no "
                         f"encoder-decoder, as in the JAX package")
    if mode in ("train", "prefill"):
        if enc_inputs is None:
            raise ValueError(f"{cfg.name}: {mode} needs the encoder's frame "
                             f"embeddings (enc_inputs [B, frames, d_model])")
        cross_kv = _encode(params, cfg, enc_inputs, mode)
    else:
        if cache is None:
            raise ValueError("decode mode needs a cache")
        cross_kv = cache["cross_kv"]
    stack = params["dec_stack"]
    st = _Stack(cache["dec_stack"] if cache is not None else None,
                len(stack), mode)
    remat = _remat(cfg, mode)
    for i, lp in enumerate(stack):
        x, nc, _, _ = _run(functools.partial(
            apply_decoder_layer, lp, cfg, mode=mode, cache=st.slot(i),
            positions=positions,
            enc_kv={key: t[i] for key, t in cross_kv.items()}), x, remat,
            cfg)
        if mode != "train":
            st.put(i, nc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE
    if mode == "train":
        return x, aux, None
    return x, aux, {"dec_stack": st.result(), "cross_kv": cross_kv}


def _apply_lora_to_attn(pa: Params, lora: Params, inv: int) -> Params:
    """The shared block with invocation ``inv``'s LoRA delta merged into
    its wq: ``wq + a @ b``, in the weights' dtype."""
    wq = dict(pa["attn"]["wq"])
    wq["w"] = wq["w"] + (lora["a"][inv] @ lora["b"][inv]).to(wq["w"].dtype)
    return {**pa, "attn": {**pa["attn"], "wq": wq}}


def init_cache(cfg, batch: int, cache_len: int, *, device="cuda") -> Params:
    """Static-shape decode caches, stacked on the layer (or invocation)
    axis; an attention cache with a sliding window holds ``min(cache_len,
    window)`` ring slots."""
    _check_ported(cfg)
    dev = resolve_device(device)

    def kv_cache(n: int, window=None):
        sc = min(cache_len, window) if window else cache_len
        shape = (n, batch, sc, cfg.n_kv_heads, cfg.dh)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                "len": torch.zeros((n,), dtype=torch.int32, device=dev)}

    def mla_cache(n: int):
        # the compressed latent and the shared rope key, no ring
        shape = (n, batch, cache_len)
        return {"ckv": torch.zeros(shape + (cfg.mla["kv_lora_rank"],),
                                   dtype=cfg.compute_dtype, device=dev),
                "kr": torch.zeros(shape + (cfg.mla["qk_rope_dim"],),
                                  dtype=cfg.compute_dtype, device=dev),
                "len": torch.zeros((n,), dtype=torch.int32, device=dev)}

    if cfg.family in ("dense", "moe"):
        n_dense = _n_dense(cfg)
        sizes = {"dense_stack": n_dense, "moe_stack": cfg.n_layers - n_dense}
        return {name: mla_cache(n) if cfg.mla else kv_cache(n, cfg.window)
                for name, n in sizes.items() if n}
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.encdec["enc_frames"],
                 cfg.n_kv_heads, cfg.dh)
        return {"dec_stack": kv_cache(cfg.n_layers, cfg.window),
                "cross_kv": {key: torch.zeros(shape, dtype=cfg.compute_dtype,
                                              device=dev)
                             for key in ("k", "v")}}
    per = ssm_lib.init_ssm_cache(cfg, batch, device=dev)
    out = {"mamba_stack": {key: t[None].repeat((cfg.n_layers,) + (1,) * t.dim())
                           for key, t in per.items()}}
    if cfg.family == "hybrid":
        out["shared_attn"] = kv_cache(n_invocations(cfg),
                                      cfg.hybrid.get("attn_window"))
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def chunked_lm_loss(params: Params, cfg, hidden: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy of hidden [B, S, d] against
    labels [B, S], weighed by ``mask`` (default all ones): the mean over
    the weighed tokens.  Each chunk of ``cfg.loss_chunk`` positions makes
    its [B, chunk, V] fp32 logits, takes the gold logit by ``gather`` (the
    JAX package contracts with a one-hot, to keep a vocab-sharded chunk
    sharded; a DTensor chunk goes through :func:`_vocab_parallel_xent`,
    which never gathers it) and is checkpointed
    when ``cfg.remat != "none"``, so that the backward holds one chunk's
    logits at a time."""
    head = params.get("lm_head", params["embed"])
    # a DTensor head gathered over its embed dim once (FSDP), so that each
    # chunk's logits shard over the vocab and the batch, never partial
    w = gather_dim(fsdp_gather(head["table"]), 1)
    s = hidden.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)

    def one(h_c, y_c, m_c):
        h_c = constrain_batch(h_c)
        wt = w.to(h_c.dtype).T
        logits = (sharded_matmul(h_c, wt) if is_dtensor(wt)
                  else h_c @ wt).float()
        if cfg.logit_scale is not None:
            logits = logits * cfg.logit_scale
        if is_dtensor(logits):
            return (_vocab_parallel_xent(logits, y_c) * m_c).sum()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
        return ((logz - gold) * m_c).sum()

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
        tot = tot + (_checkpoint(one, *args) if remat else one(*args))
    return tot / mask.float().sum().clamp_min(1.0)


def _vocab_parallel_xent(logits, labels):
    """Per-token cross-entropy of a DTensor logits chunk [B, c, V] whose
    vocab may shard over mesh dims, Megatron's way: each rank reduces its
    own columns (``local_map``) to a row max, a sum of exponentials and
    the gold logit where the label falls in its columns, and only those
    [B, c] partial results cross ranks (a max and two sum all-reduces);
    the chunk itself is never gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.sharding import shard_offset
    mesh = logits.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    vocab = [m for m, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    rows = tuple(Replicate() if m in vocab else p for m, p in enumerate(pl))
    labels = labels.redistribute(mesh, rows) if is_dtensor(labels) \
        else labels

    def partial(op):
        return tuple(Partial(op) if m in vocab else p
                     for m, p in enumerate(rows))

    def reduced(x):
        return x.redistribute(mesh, rows)

    mx = reduced(local_map(lambda t: t.amax(-1), out_placements=(
        partial("max"),), in_placements=(pl,), device_mesh=mesh)(
        logits.detach()))
    se = local_map(lambda t, m: torch.exp(t - m[..., None]).sum(-1),
                   out_placements=(partial("sum"),),
                   in_placements=(pl, rows), in_grad_placements=(pl, rows),
                   device_mesh=mesh)(logits, mx)
    logz = reduced(se).log() + mx
    start = shard_offset(mesh, vocab, logits.shape[-1], logits.device)

    def gold_local(t, y):
        rel = y.long() - start
        hit = (rel >= 0) & (rel < t.shape[-1])
        g = torch.gather(t, -1, torch.where(hit, rel, 0)[..., None])[..., 0]
        return g * hit.to(g.dtype)

    gold = reduced(local_map(gold_local, out_placements=(partial("sum"),),
                             in_placements=(pl, rows),
                             in_grad_placements=(pl, rows),
                             device_mesh=mesh)(logits, labels))
    return logz - gold


def lm_loss(params: Params, cfg, batch: dict):
    """batch: {"tokens": [B,S], "labels": [B,S], optional "enc_inputs"
    [B, frames, d] and "loss_mask" [B,S]} → ``(loss, metrics)``: the
    cross-entropy (``metrics["xent"]``), plus ``mtp_weight`` times the MTP
    loss (``metrics["mtp"]``, with ``cfg.mtp`` and an ``mtp`` subtree), plus
    the MoE config's ``aux_weight`` times the load-balancing loss
    (``metrics["moe_aux"]``)."""
    hidden, aux, _ = forward(params, cfg, batch["tokens"], mode="train",
                             enc_inputs=batch.get("enc_inputs"),
                             return_hidden=True)
    loss = chunked_lm_loss(params, cfg, hidden, batch["labels"],
                           batch.get("loss_mask"))
    metrics = {"xent": loss, "moe_aux": aux}
    if cfg.mtp and "mtp" in params:
        mtp_l = _mtp_loss(params, cfg, hidden, batch["labels"])
        loss = loss + cfg.mtp_weight * mtp_l
        metrics["mtp"] = mtp_l
    moe_w = (cfg.moe or {}).get("aux_weight", 0.0)
    return loss + moe_w * aux, metrics


def _mtp_loss(params: Params, cfg, hidden: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3 MTP: h'_i = proj([norm(h_i); norm(emb(t_{i+1}))]) → one
    dense block → the shared head → predict t_{i+2} (the labels shifted
    left once more, the last position masked)."""
    mp = params["mtp"]
    s = hidden.shape[1]
    emb_next = embed(params["embed"], labels).to(cfg.compute_dtype)
    h = torch.cat([apply_norm(mp["norm_h"], hidden, kind=cfg.norm),
                   apply_norm(mp["norm_e"], emb_next, kind=cfg.norm)], dim=-1)
    h = (h @ mp["proj"]).to(cfg.compute_dtype)
    h, _, _, _ = apply_decoder_layer(
        mp["layer"], cfg, h, mode="train", cache=None,
        positions=torch.arange(s, dtype=torch.int32, device=h.device))
    labels2 = torch.roll(labels, -1, dims=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    mask[:, -1] = 0.0
    return chunked_lm_loss(params, cfg, h, labels2, mask)


def param_count(params: Params) -> int:
    """Number of parameter elements (tied embeddings counted once)."""
    def walk(t: Any) -> int:
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        return sum(walk(v) for v in t)
    return walk(params)


__all__ = ["apply_decoder_layer", "apply_mamba_layer", "chunked_lm_loss",
           "forward", "init", "init_cache", "init_decoder_layer",
           "init_mamba_layer", "lm_loss", "make_generator", "n_invocations",
           "param_count"]
