"""Learning-rate schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM).

WSD is the schedule the MiniCPM paper contributes: linear warmup → long
constant ("stable") phase → short exponential decay tail.  Unlike cosine
it decouples the total-token count from the decay horizon.  Each returns
an fp32 tensor of the step's shape, as the JAX package's ``jnp`` ones do.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak_lr * cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1,
                 final_frac: float = 0.01) -> torch.Tensor:
    """Warmup-Stable-Decay: MiniCPM §4 (decay tail = last `decay_frac`)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    # exponential decay tail: lr = peak * final_frac^(t/T_decay)
    t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                    0.0, 1.0)
    dec = peak_lr * torch.pow(final_frac, t)
    stable = torch.full_like(step, peak_lr)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, stable, dec))


def make_schedule(kind: str, **kw):
    fn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[kind]
    return lambda step: fn(step, **kw)
