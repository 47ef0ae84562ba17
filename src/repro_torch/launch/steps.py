"""Step builders: train (loss, gradients, optional gradient accumulation,
clipping and AdamW), prefill (one-shot, or chunked window by window when
the config sets ``prefill_chunk``) and serve (one decode step), for every
family of ``models/model.py`` (dense, MoE with or without a sliding window
or MLA, SSM, hybrid, encoder-decoder).  The encoder-decoder's prefill takes
the frame embeddings and caches the encoder's cross K/V; its serve step
reads them from the cache and takes no frames.

The JAX package's ``launch/steps.py`` also builds the jitted, sharded
variants for its dry-run (ROADMAP.md, module step 10); those have no port
yet.  PyTorch runs eagerly, so each ``make_*_step`` returns a plain
function.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               tree_leaves, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The JAX package's train options, field for field.  ``fsdp``,
    ``fsdp_over_pod``, ``parallelism`` and ``offload_opt_state`` place
    parameters and moments on a mesh; on one card they have no effect
    (module step 10 decides their meaning on several cards)."""
    peak_lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    max_grad_norm: float = 1.0
    opt_state_policy: str = "fp32"   # fp32 | bf16 | q8
    fsdp: bool = True
    microbatch: int = 0              # >1: grad-accumulation chunks
    grad_accum_dtype: str = "fp32"   # fp32 | bf16 (≥300B models)
    fsdp_over_pod: bool = False      # ZeRO across pods (≥300B models)
    parallelism: str = "2d"          # 2d (TP×FSDP) | fsdp_only
    residual_budget: float = 4e9     # microbatch sizing target
    offload_opt_state: bool = False  # host-resident moments (no effect)


def default_train_options(cfg: ModelConfig) -> TrainOptions:
    """Size-adaptive defaults: big models get low-precision moments."""
    n = est_param_count(cfg)
    if n > 3e11:
        return TrainOptions(opt_state_policy="q8", grad_accum_dtype="bf16",
                            fsdp_over_pod=True)
    if n > 2e10:
        return TrainOptions(opt_state_policy="bf16")
    return TrainOptions()


def auto_microbatch(cfg: ModelConfig, shape: ShapeSpec,
                    residual_budget: float = 4e9) -> int:
    """Grad-accumulation chunks bounding the saved-residual footprint on
    one device (the JAX package divides the batch over its mesh's data
    axes first; here their size is 1).

    The layer loop saves one d_model residual per layer per live token
    (full-remat policy), i.e. ``L·d·2B`` bytes/token.  Choose the smallest
    power-of-two split keeping that under ``residual_budget``.
    """
    b_local = max(shape.global_batch, 1)
    tokens = b_local * shape.seq_len
    per_token = cfg.n_layers * cfg.d_model * 2  # bf16 residual per layer
    tokens_budget = max(int(residual_budget / per_token), shape.seq_len)
    mb = 1
    while (tokens // mb > tokens_budget and mb < b_local
           and b_local % (mb * 2) == 0):
        mb *= 2
    return mb


def est_param_count(cfg: ModelConfig) -> float:
    """Closed-form parameter estimate (embeddings + stacks)."""
    d = cfg.d_model
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    per_attn = d * cfg.n_heads * cfg.dh * 2 + d * cfg.n_kv_heads * cfg.dh * 2
    if cfg.mla:
        m = cfg.mla
        per_attn = (d * m["q_lora_rank"]
                    + m["q_lora_rank"] * cfg.n_heads * (m["qk_nope_dim"] + m["qk_rope_dim"])
                    + d * (m["kv_lora_rank"] + m["qk_rope_dim"])
                    + m["kv_lora_rank"] * cfg.n_heads * (m["qk_nope_dim"] + m["v_head_dim"])
                    + cfg.n_heads * m["v_head_dim"] * d)
    mlp_mult = 3 if cfg.act == "swiglu" else 2
    per_mlp = mlp_mult * d * cfg.d_ff
    if cfg.family == "ssm" or cfg.family == "hybrid":
        s = cfg.ssm
        per_ssm = d * s["d_inner"] * 3 + 2 * d * s["d_state"] * 2
        n = cfg.n_layers * per_ssm + emb
        if cfg.family == "hybrid":
            n += per_attn + per_mlp
        return n
    if cfg.moe:
        mo = cfg.moe
        per_moe = mo["n_experts"] * 3 * d * mo["d_ff"] + \
            mo.get("shared_expert", 0) * 3 * d * mo["d_ff"] + d * mo["n_experts"]
        nd = mo.get("first_dense", 0)
        return emb + nd * (per_attn + per_mlp) + \
            (cfg.n_layers - nd) * (per_attn + per_moe)
    n_stacks = 1 + (cfg.encdec["enc_layers"] / cfg.n_layers if cfg.encdec else 0)
    return emb + cfg.n_layers * n_stacks * (per_attn + per_mlp)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """``lm_loss`` and its gradient with respect to every parameter leaf
    (``jax.value_and_grad`` of the JAX package's ``lm_loss``) → ``(loss,
    metrics, grads)``, all detached; ``grads`` has the parameters'
    structure and dtypes, zeros for a leaf the loss does not reach (the
    routing bias).  The leaves record gradients only during the call."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = M.lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def _accumulated_grads(params, cfg: ModelConfig, batch: dict, n_micro: int,
                       acc_dtype=torch.float32):
    """Gradient accumulation over ``n_micro`` batch-split microbatches →
    ``(loss, metrics, grads)``: the mean loss, the last microbatch's
    metrics, and the mean gradient in ``acc_dtype`` (``bf16`` halves the
    standing accumulator for ≥300B models)."""
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not a multiple of {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    acc = [torch.zeros(t.shape, dtype=acc_dtype, device=t.device)
           for t in tree_leaves(params)]
    total = torch.zeros((), dtype=torch.float32,
                        device=batch["tokens"].device)
    for i in range(n_micro):
        micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
        loss, metrics, grads = loss_and_grads(params, cfg, micro)
        for a, g in zip(acc, tree_leaves(grads)):
            a.add_(g.to(acc_dtype))
        total = total + loss
        del grads
    scale = 1.0 / n_micro  # n_micro is a power of two: exact in bf16
    for a in acc:
        a.mul_(scale)
    return total * scale, metrics, tree_unflatten(params, acc)


def make_train_step(cfg: ModelConfig, opts: TrainOptions):
    """(params, opt_state, batch) → (params, opt_state, metrics): the loss
    and its gradients (over ``opts.microbatch`` microbatches if above 1),
    clipped to ``max_grad_norm``, then one AdamW step at ``peak_lr`` (the
    driver applies schedules) that updates ``params`` and ``opt_state``
    in place.  ``metrics``: ``loss``, ``xent``, ``moe_aux``, ``mtp`` (with
    MTP) and ``grad_norm``, device tensors."""
    def train_step(params, opt_state, batch):
        if opts.microbatch and opts.microbatch > 1:
            loss, metrics, grads = _accumulated_grads(
                params, cfg, batch, opts.microbatch,
                acc_dtype=torch.bfloat16 if opts.grad_accum_dtype == "bf16"
                else torch.float32)
        else:
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, opts.max_grad_norm)
            params, opt_state = adamw_update(
                grads, opt_state, params, lr=opts.peak_lr, b1=opts.b1,
                b2=opts.b2, weight_decay=opts.weight_decay,
                state_policy=opts.opt_state_policy)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


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
