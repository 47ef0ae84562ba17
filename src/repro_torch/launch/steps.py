"""Step builders: train (loss, gradients, optional gradient accumulation,
clipping and AdamW), prefill (one-shot, or chunked window by window when
the config sets ``prefill_chunk``) and serve (one decode step), for every
family of ``models/model.py`` (dense, MoE with or without a sliding window
or MLA, SSM, hybrid, encoder-decoder).  The encoder-decoder's prefill takes
the frame embeddings and caches the encoder's cross K/V; its serve step
reads them from the cache and takes no frames.

PyTorch runs eagerly, so each ``make_*_step`` returns a plain function.
:func:`build_sharded` is the counterpart of the JAX package's
``build_jitted``: it places the parameters, the optimizer state, the batch
and the caches on a DeviceMesh as DTensors (``launch/sharding.py``'s
specs) and returns the step, run under the mesh (``models/pjit_utils.
use_mesh``), with its arguments.  The same step functions run unsharded
on plain tensors and sharded on DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.pjit_utils import is_dtensor
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               tree_leaves, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The JAX package's train options, field for field.  ``fsdp``,
    ``fsdp_over_pod`` and ``parallelism`` choose the sharding rules
    (``launch/sharding.py``) that :func:`build_sharded` places parameters,
    moments and batches by; an unsharded step ignores them.
    ``offload_opt_state`` is a field only, in the JAX package too (nothing
    reads it there): it has no effect."""
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


def auto_microbatch(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                    residual_budget: float = 4e9,
                    parallelism: str = "2d") -> int:
    """Grad-accumulation chunks bounding the saved-residual footprint per
    device: the batch is divided over the mesh's batch dims first (``mesh``
    a DeviceMesh or ``{name: size}``; None is one device).

    The layer loop saves one d_model residual per layer per live token
    (full-remat policy), i.e. ``L·d·2B`` bytes/token.  Choose the smallest
    power-of-two split keeping that under ``residual_budget``.
    """
    data_sz = 1
    if mesh is not None:
        from .mesh import batch_axes, mesh_shape
        sizes = mesh_shape(mesh)
        axes = list(batch_axes(sizes))
        if parallelism == "fsdp_only":
            axes.append("model")
        for a in axes:
            data_sz *= sizes[a]
    b_local = max(shape.global_batch // data_sz, 1)
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

def _like_param(g, p):
    """A DTensor gradient placed as its parameter (partial sums reduced,
    or reduce-scattered onto the parameter's shards)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows(x, i: int, n: int):
    """Microbatch ``i`` of ``n``: rows ``[i·b/n, (i+1)·b/n)`` of a plain
    tensor; of a DTensor batch-sharded on dim 0, those rows of each rank's
    shard (the same mean gradient over ``n`` equal microbatches, and no
    rank gathers the batch)."""
    if is_dtensor(x) and any(getattr(pl, "dim", None) == 0
                             for pl in x.placements):
        from torch.distributed.tensor import DTensor
        loc = x.to_local()
        mb = loc.shape[0] // n
        return DTensor.from_local(loc[i * mb:(i + 1) * mb], x.device_mesh,
                                  x.placements, run_check=False)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


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
    grads = [torch.zeros_like(t) if g is None else _like_param(g, t)
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
    acc = [torch.zeros_like(t, dtype=acc_dtype)
           for t in tree_leaves(params)]
    total = 0.0
    for i in range(n_micro):
        micro = {k: _rows(x, i, n_micro) for k, x in batch.items()}
        loss, metrics, grads = loss_and_grads(params, cfg, micro)
        for j, g in enumerate(tree_leaves(grads)):
            acc[j] = _acc_add(acc[j], g.to(acc_dtype))
        total = total + loss
        del grads
    scale = 1.0 / n_micro  # n_micro is a power of two: exact in bf16
    acc = [a * scale if is_dtensor(a) else a.mul_(scale)
           for a in acc]
    return total * scale, metrics, tree_unflatten(params, acc)


def _acc_add(a, g):
    """``a + g`` into ``a``'s storage; a DTensor out of place (a replicated
    DTensor's local tensor may be one tensor for every rank that
    ``LocalTensorMode`` simulates, which an in-place add would update once
    per rank)."""
    return a + g if is_dtensor(a) else a.add_(g)


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


# ---------------------------------------------------------------------------
# sharded assembly for a DeviceMesh (the JAX package's build_jitted)
# ---------------------------------------------------------------------------

def _place(tree, specs, mesh, *, seed: Optional[int] = None, device=None,
           fill=None):
    """DTensors of ``tree``'s leaves placed by ``specs`` on ``mesh``.  With
    ``seed`` None each whole leaf is distributed (``distribute_tensor``);
    otherwise ``tree`` holds shapes (fake tensors) and each rank draws only
    its own shard on ``device``, never the whole tensor: N(0, 0.02) floats
    from the seed, or ``fill(name, local_shape, dtype)`` where given."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from . import sharding as shd
    gen = None
    if seed is not None:
        gen = torch.Generator(device=device).manual_seed(seed)

    def one(path, t, spec):
        pl = shd.placements(spec, mesh)
        if gen is None:
            return distribute_tensor(t, mesh, pl)
        loc = shd.local_shape(t.shape, spec, mesh)
        val = fill(path[-1], loc, t.dtype) if fill else None
        if val is None:
            if t.dtype.is_floating_point:
                val = (torch.randn(loc, generator=gen, device=device)
                       * 0.02).to(t.dtype)
            else:
                val = torch.zeros(loc, dtype=t.dtype, device=device)
        return DTensor.from_local(val, mesh, pl, run_check=False,
                                  shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())

    def walk(path, t, s):
        if isinstance(s, tuple):          # a spec
            return one(path, t, s)
        if isinstance(s, dict):
            return {k: walk(path + (k,), t[k], s[k]) for k in s}
        return [walk(path + (i,), a, b) for i, (a, b) in
                enumerate(zip(t, s))]

    return walk((), tree, specs)


def _sharded(fn, mesh, parallelism: str):
    def step(*args):
        from repro_torch.models.pjit_utils import use_mesh
        with use_mesh(mesh, parallelism):
            return fn(*args)
    step.__name__ = getattr(fn, "__name__", "step")
    return step


def build_sharded(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  opts: Optional[TrainOptions] = None, *, params=None,
                  batch=None, cache=None, seed: Optional[int] = None,
                  device=None):
    """The step of ``shape.kind`` on the DeviceMesh ``mesh`` → ``(step,
    args)``: ``step(*args)`` runs it under the mesh.  ``args`` are
    DTensors placed by the JAX package's specs (``fsdp``,
    ``fsdp_over_pod`` and ``parallelism`` from ``opts``):

      * train: ``(params, opt_state, batch)``, moments by
        ``opt_state_specs`` (q8 scales drop the last axis); ``microbatch``
        0 means :func:`auto_microbatch` on this mesh;
      * prefill: ``(params, tokens)`` (and ``enc_inputs`` for whisper);
      * decode: ``(params, cache, tokens, pos)``, the cache by
        ``cache_specs``, full (``len`` = seq_len - 1).

    Given ``params`` (and ``batch`` / ``cache``), whole tensors are
    distributed; with ``seed`` instead, every rank draws its own shards
    on ``device`` from the seed and nothing is materialised whole (the
    dry run; batch tokens are zeros)."""
    from repro_torch.models.logical import param_logical, param_shapes
    from repro_torch.optim import adamw_init
    from . import sharding as shd
    from .sharding import P

    opts = opts or default_train_options(cfg)
    shapes = param_shapes(cfg)
    pspecs = shd.param_specs(shapes, param_logical(cfg), cfg, mesh,
                             fsdp=opts.fsdp, fsdp_over_pod=opts.fsdp_over_pod,
                             parallelism=opts.parallelism)
    drawn = params is None
    if drawn and seed is None:
        raise ValueError("build_sharded needs params or a seed")
    d_params = (_place(shapes, pspecs, mesh, seed=seed, device=device)
                if drawn else shd.shard_tree(params, pspecs, mesh))
    b, s = shape.global_batch, shape.seq_len
    bsp = shd.batch_spec(b, mesh, ndim=2, parallelism=opts.parallelism)

    def fake(fn):
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            return fn()

    def tokens_like(n_seq):
        return fake(lambda: torch.zeros((b, n_seq), dtype=torch.int32))

    if shape.kind == "train":
        if opts.microbatch == 0:
            opts = dataclasses.replace(opts, microbatch=auto_microbatch(
                cfg, shape, mesh, residual_budget=opts.residual_budget,
                parallelism=opts.parallelism))
        st_shapes = fake(lambda: adamw_init(shapes,
                                            state_policy=opts.opt_state_policy))
        ospecs = shd.opt_state_specs(pspecs, st_shapes)
        if drawn:       # zeroed moments, as adamw_init makes them
            d_state = _place(st_shapes, ospecs, mesh, seed=seed,
                             device=device,
                             fill=lambda _, loc, dt: torch.zeros(
                                 loc, dtype=dt, device=device))
        else:
            d_state = shd.shard_tree(
                adamw_init(params, state_policy=opts.opt_state_policy),
                ospecs, mesh)
        bspecs = {"tokens": bsp, "labels": bsp}
        if cfg.encdec:
            bspecs["enc_inputs"] = P(bsp[0], None, None)
        if batch is None:
            bt = {"tokens": tokens_like(s), "labels": tokens_like(s)}
            if cfg.encdec:
                bt["enc_inputs"] = fake(lambda: torch.zeros(
                    (b, cfg.encdec["enc_frames"], cfg.d_model),
                    dtype=cfg.compute_dtype))
            d_batch = _place(bt, bspecs, mesh, seed=seed, device=device)
        else:
            d_batch = shd.shard_tree(batch, {k: bspecs[k] for k in batch},
                                     mesh)
        step = _sharded(make_train_step(cfg, opts), mesh, opts.parallelism)
        return step, (d_params, d_state, d_batch)
    if shape.kind == "prefill":
        toks = batch["tokens"] if batch is not None else None
        d_tok = (shd.shard_tree(toks, bsp, mesh) if toks is not None else
                 _place(tokens_like(s), bsp, mesh, seed=seed, device=device))
        args = (d_params, d_tok)
        if cfg.encdec:
            esp = P(bsp[0], None, None)
            enc = batch["enc_inputs"] if batch is not None else fake(
                lambda: torch.zeros((b, cfg.encdec["enc_frames"],
                                     cfg.d_model), dtype=cfg.compute_dtype))
            args += ((shd.shard_tree(enc, esp, mesh) if batch is not None
                      else _place(enc, esp, mesh, seed=seed,
                                  device=device)),)
        step = _sharded(make_prefill_step(cfg), mesh, opts.parallelism)
        return step, args
    # decode: one new token against a full cache of seq_len
    c_shapes = fake(lambda: M.init_cache(cfg, b, s, device="cpu"))
    cspecs = shd.cache_specs(cfg, c_shapes, mesh, b)
    if cache is None:
        def fill(name, loc, dt):
            if name == "len":
                return torch.full(loc, s - 1, dtype=dt, device=device)
            return torch.zeros(loc, dtype=dt, device=device)
        d_cache = _place(c_shapes, cspecs, mesh, seed=seed, device=device,
                         fill=fill)
    else:
        d_cache = shd.shard_tree(cache, cspecs, mesh)
    toks = batch["tokens"] if batch is not None else None
    d_tok = (shd.shard_tree(toks, bsp, mesh) if toks is not None else
             _place(fake(lambda: torch.zeros((b, 1), dtype=torch.int32)),
                    bsp, mesh, seed=seed, device=device))
    pos = _first_len(d_cache)
    step = _sharded(make_serve_step(cfg), mesh, opts.parallelism)
    return step, (d_params, d_cache, d_tok, pos)


def _first_len(cache):
    """The cache cursor: the first stack's ``len`` [L], entry 0 (a
    replicated DTensor, never read back to the host)."""
    for sub in cache.values():
        if "len" in sub:
            return sub["len"][0]
    raise ValueError("the cache has no len")
