"""qwen3-1.7b [dense] — 28L d2048 16H (GQA kv=8) ffn6144 vocab151936.

Per-head q/k RMS-norm, tied embeddings.  [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    norm="rmsnorm", act="swiglu", rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
)
