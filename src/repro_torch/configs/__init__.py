"""Config registry: one module per assigned architecture (+ the paper's own
D4M benchmark workload in ``d4m_bench``).

``get_config(name)`` → full published config; ``get_smoke(name)`` → reduced
same-family config for CPU smoke tests; ``shapes_for(name)`` → the
assigned shape cells.  The registry names the same ten architectures as
the JAX package, and every one of them is in :data:`PORTED`: each has a
config module here and serves (training is ROADMAP.md's module step 9e).
"""
from __future__ import annotations

import importlib
from typing import List

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, ShapeSpec)

ARCH_IDS: List[str] = [
    "chatglm3_6b",
    "qwen3_1_7b",
    "starcoder2_7b",
    "minicpm_2b",
    "whisper_medium",
    "deepseek_v3_671b",
    "mixtral_8x22b",
    "chameleon_34b",
    "mamba2_130m",
    "zamba2_7b",
]
PORTED: List[str] = list(ARCH_IDS)     # all ten serve (module steps 9-9d)


def _normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _mod(name: str):
    name = _normalize(name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).SMOKE


def shapes_for(name: str) -> List[ShapeSpec]:
    """The assigned shape cells for an architecture, with documented skips."""
    cfg = get_config(name)
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
    if not sub_quadratic_decode(cfg):
        out.remove(LONG_500K)  # pure full-attention arch
    return out


def sub_quadratic_decode(cfg: ModelConfig) -> bool:
    """long_500k eligibility: SSM/hybrid state or sliding-window cache."""
    return cfg.family in ("ssm", "hybrid") or cfg.window is not None


__all__ = ["ARCH_IDS", "PORTED", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke", "shapes_for", "sub_quadratic_decode", "ALL_SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"]
