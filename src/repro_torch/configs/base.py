"""Architecture/config schema shared by all assigned architectures.

Every ``repro_torch/configs/<arch>.py`` exports ``CONFIG`` (the exact
published configuration) and ``SMOKE`` (a reduced same-family config for CPU
tests).  ``repro_torch.launch`` consumes these via
:func:`repro_torch.configs.get_config`.  The fields are those of the JAX
package's schema, so that later families port without touching it; the
dtypes are torch dtypes and ``attn_impl`` takes the port's kernel routes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    norm: str = "rmsnorm"
    act: str = "swiglu"
    pos_emb: str = "rope"            # rope | sinusoidal | learned
    rope_theta: Optional[float] = 10000.0
    rotary_dim: Optional[int] = None  # partial ("2d") RoPE if < head_dim
    qk_norm: bool = False
    attn_bias: bool = False
    window: Optional[int] = None     # sliding-window attention
    tie_embeddings: bool = False
    scale_emb: float = 1.0           # μP-style embedding scale (MiniCPM)
    scale_depth: Optional[float] = None  # residual scale s/√L (MiniCPM)
    logit_scale: Optional[float] = None
    max_seq: int = 544768            # learned-pos capacity / rope cache bound
    moe: Optional[Dict[str, Any]] = None
    ssm: Optional[Dict[str, Any]] = None
    hybrid: Optional[Dict[str, Any]] = None
    encdec: Optional[Dict[str, Any]] = None
    mla: Optional[Dict[str, Any]] = None
    mtp: bool = False                # DeepSeek multi-token prediction head
    mtp_weight: float = 0.1
    # numerics / implementation policy
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # auto: the flash-attention kernel on CUDA tensors, its plain version on
    # CPU tensors | cuda: the kernel (CUDA tensors only) | ref: the plain
    # query-chunked path (the JAX package's "reference")
    attn_impl: str = "auto"
    attn_chunk: int = 512            # query-chunk for the plain path
    prefill_chunk: Optional[int] = None  # window-wise cache build (long ctx)
    loss_chunk: int = 512            # sequence chunk for chunked xent
    remat: str = "full"              # none | full  (per-layer checkpoint)
    # sharding hints of the JAX package (no single-card meaning; kept so
    # that configs read the same in both packages)
    shard_ssm_heads: bool = True
    moe_sharding: str = "ep"
    seq_parallel: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: what to run and at what size."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def step(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
