"""chatglm3-6b [dense] — 28L d4096 32H (GQA kv=2) ffn13696 vocab65024.

RoPE applied to half the head dim ("2d" rotary), multi-query-style GQA with
2 KV groups.  [arXiv:2406.12793; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, rotary_dim=64,  # 2d RoPE: half of head_dim
    norm="rmsnorm", act="swiglu", rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, rotary_dim=8, attn_chunk=64, loss_chunk=32, max_seq=512,
)
