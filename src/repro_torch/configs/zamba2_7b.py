"""zamba2-7b [hybrid] — 81L d3584 (Mamba2 backbone) + shared attn blocks.

81 Mamba2 layers (d_inner 7168, state 64, head_dim 64 ⇒ 112 SSM heads,
16-way shardable); ONE shared attention+MLP block (32 heads, d_ff 14336)
invoked every 6 layers with a per-invocation LoRA delta on wq — the Zamba2
weight-sharing trick.  Hybrid state ⇒ long_500k runs (full attention in the
~14 shared invocations; the SSM carries the long-range state).
[arXiv:2411.15242]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112, norm="rmsnorm", act="swiglu",
    rope_theta=10000.0,
    ssm={"d_inner": 7168, "d_state": 64, "head_dim": 64, "d_conv": 4,
         "n_groups": 1, "chunk": 128},
    hybrid={"attn_every": 6, "lora_rank": 128},
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
    ssm={"d_inner": 128, "d_state": 16, "head_dim": 32, "d_conv": 4,
         "n_groups": 1, "chunk": 32},
    hybrid={"attn_every": 2, "lora_rank": 8},
)
