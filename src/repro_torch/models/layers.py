"""Shared neural-net building blocks on torch tensors.

Parameters are plain nested dicts of tensors, as in the JAX package, so that
:mod:`repro_torch.convert` maps one onto the other leaf by leaf.  A linear
weight ``w`` keeps the JAX layout ``[d_in, d_out]`` (``y = x @ w``), not
torch's ``[d_out, d_in]``.  The ``init_*`` functions draw from an explicit
``torch.Generator`` (normal in float32, scaled, then cast, as the JAX package
draws), on the generator's device, and return the parameters only: the JAX
package's logical sharding specs have no meaning on one card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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
        return (xf * p["g"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["g"].float() + p["b"].float()).to(x.dtype)


def rms_norm_simple(x: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * g.float()).to(x.dtype)


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
    out = p["table"][ids]
    return out * scale if scale != 1.0 else out


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
