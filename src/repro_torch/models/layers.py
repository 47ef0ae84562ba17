"""Shared neural-net building blocks on torch tensors.

Parameters are plain nested dicts of tensors, as in the JAX package, so that
:mod:`repro_torch.convert` maps one onto the other leaf by leaf.  A linear
weight ``w`` keeps the JAX layout ``[d_in, d_out]`` (``y = x @ w``), not
torch's ``[d_out, d_in]``.  The ``init_*`` functions draw from an explicit
``torch.Generator`` (normal in float32, scaled, then cast, as the JAX package
draws), on the generator's device, and return the parameters only: their
logical axis names, the JAX ``init_*`` functions' second return value,
are the tree of :func:`repro_torch.models.logical.param_logical`, which
the sharding rules (``launch/sharding.py``) read.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .pjit_utils import fsdp_gather as fsdp
from .pjit_utils import is_dtensor

Params = Dict[str, Any]

# the leaves that the JAX init keeps in fp32 at any param_dtype: the SSM
# mixer's (models/ssm.py) and the MoE router's (models/moe.py)
FP32_LEAVES = ("dt_bias", "a_log", "d_skip", "router", "e_bias")


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def init_linear(gen, d_in: int, d_out: int, *, dtype,
                scale: Optional[float] = None, bias: bool = False) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    y = sharded_matmul(x, fsdp(w)) if is_dtensor(w) else x @ w
    if "b" in p:
        y = y + fsdp(p["b"])
    return y


def sharded_matmul(x, w):
    """``x @ w`` for a DTensor weight [d_in, d_out] (FSDP-gathered: only
    its tensor-parallel shards left), on each rank's local blocks
    (``local_map``), with Megatron's placements fixed per mesh dim: a
    batch-sharded ``x`` against a replicated ``w`` stays batch-sharded (the
    weight's gradient a partial sum); a replicated ``x`` against a
    column-sharded ``w`` gives column-sharded output (``x``'s gradient a
    partial sum); an ``x`` sharded on its last dim against a row-sharded
    ``w`` gives a partial sum.  Fixing them keeps DTensor's cost model from
    choosing, in the backward, a weight gathered whole over `model`."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    last = x.ndim - 1
    xs = list(x.placements) if is_dtensor(x) else [Replicate()] * mesh.ndim
    x_pl, out_pl, gx_pl, gw_pl = [], [], [], []
    for xp, wp in zip(xs, w.placements):
        if xp.is_partial():
            xp = Replicate()
        if isinstance(wp, Shard) and wp.dim == 0:          # row-parallel
            x_pl.append(Shard(last))
            out_pl.append(Partial())
            gx_pl.append(Shard(last))
            gw_pl.append(wp)
        elif isinstance(wp, Shard):                         # column-parallel
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
            gx_pl.append(Partial())
            gw_pl.append(wp)
        elif isinstance(xp, Shard) and xp.dim != last:      # batch
            x_pl.append(xp)
            out_pl.append(xp)
            gx_pl.append(xp)
            gw_pl.append(Partial())
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
            gx_pl.append(Replicate())
            gw_pl.append(Replicate())
    return local_map(torch.matmul, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(x_pl), tuple(w.placements)),
                     in_grad_placements=(tuple(gx_pl), tuple(gw_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


# -- normalization -----------------------------------------------------------

def init_norm(d: int, *, kind: str, dtype, device) -> Params:
    p = {"g": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, *, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * fsdp(p["g"]).float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * fsdp(p["g"]).float() + fsdp(p["b"]).float()).to(x.dtype)


def rms_norm_simple(x: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * fsdp(g).float()).to(x.dtype)


# -- MLPs ---------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, *, act: str, dtype,
             bias: bool = False) -> Params:
    if act == "swiglu":
        return {"gate": init_linear(gen, d_model, d_ff, dtype=dtype),
                "up": init_linear(gen, d_model, d_ff, dtype=dtype),
                "down": init_linear(gen, d_ff, d_model, dtype=dtype)}
    return {"up": init_linear(gen, d_model, d_ff, dtype=dtype, bias=bias),
            "down": init_linear(gen, d_ff, d_model, dtype=dtype, bias=bias)}


def apply_mlp(p: Params, x: torch.Tensor, *, act: str) -> torch.Tensor:
    if act == "swiglu":
        return linear(p["down"],
                      F.silu(linear(p["gate"], x)) * linear(p["up"], x))
    h = F.gelu(linear(p["up"], x), approximate="tanh")
    return linear(p["down"], h)


# -- embeddings ----------------------------------------------------------------

def init_embedding(gen, vocab: int, d_model: int, *, dtype,
                   scale: float = 1.0) -> Params:
    return {"table": _normal(gen, (vocab, d_model), scale, dtype)}


def embed(p: Params, ids: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    table = p["table"]
    if is_dtensor(table):
        out = _embed_sharded(table, ids)
    else:
        out = table[ids]
    return out * scale if scale != 1.0 else out


def _embed_sharded(table, ids):
    """The lookup on a DTensor table, vocab-parallel: the table is gathered
    over its embed dim and stays sharded over the vocab; each rank looks
    up the ids that fall in its rows (``local_map``; the others give
    zeros), so the result is a partial sum over the vocab's mesh dims and
    a table's gradient a partial sum over the batch's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.sharding import shard_offset
    from .pjit_utils import gather_dim
    mesh = table.device_mesh
    if not is_dtensor(ids):
        from torch.distributed.tensor import distribute_tensor
        ids = distribute_tensor(ids, mesh, [Replicate()] * mesh.ndim)
    t_pl, i_pl = list(gather_dim(table, 1).placements), list(ids.placements)
    for m, (tp, ip) in enumerate(zip(t_pl, i_pl)):
        if isinstance(tp, Shard) and isinstance(ip, Shard):
            t_pl[m] = Replicate()        # one mesh dim cannot shard both
    vocab_dims = [m for m, tp in enumerate(t_pl) if isinstance(tp, Shard)]
    out_pl = tuple(Partial() if m in vocab_dims else ip
                   for m, ip in enumerate(i_pl))
    grad_pl = tuple(tp if isinstance(tp, Shard) else (
        Partial() if isinstance(ip, Shard) else Replicate())
        for tp, ip in zip(t_pl, i_pl))
    start = (shard_offset(mesh, vocab_dims, table.shape[0], table.device)
             if vocab_dims else None)

    def local(t, i):
        if start is None:
            return F.embedding(i, t)
        rel = i - start
        hit = (rel >= 0) & (rel < t.shape[0])
        out = F.embedding(torch.where(hit, rel, 0), t)
        return out * hit[..., None].to(out.dtype)

    return local_map(local, out_placements=(out_pl,),
                     in_placements=(tuple(t_pl), tuple(i_pl)),
                     in_grad_placements=(grad_pl, tuple(i_pl)),
                     device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits; fp32 for numerical stability of the softmax/xent."""
    return (x @ p["table"].to(x.dtype).T).float()


def sinusoidal_positions(n: int, d: int, *, device=None) -> torch.Tensor:
    """[n, d] fp32: sin of position · 10000^(-2i/d) in the first d/2
    columns, cos in the rest (whisper's encoder; the caller casts)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2 * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- rotary position embeddings --------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor,
               rotary_dim: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables; ``rotary_dim < head_dim`` gives partial ("2d") RoPE."""
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32,
                        device=positions.device) / rd
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv          # [..., S, rd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """x: [..., S, H, Dh]; rotate the first ``rotary_dim`` dims in
    interleaved pairs ``(x[0::2], x[1::2])``, as the JAX package does (not
    the half-split ``rotate_half`` of other implementations)."""
    rd = rotary_dim or x.shape[-1]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., :, None, :]                          # broadcast over heads
    s = sin[..., :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < x.shape[-1] else rot


# -- misc -------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits fp32 [..., V], labels int [...];
    with ``mask`` the mean over the tokens it weighs."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
