"""starcoder2-7b [dense] — 32L d4608 36H (GQA kv=4) ffn18432 vocab49152.

GeLU MLP, LayerNorm with bias, RoPE.  [arXiv:2402.19173; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, head_dim=128, norm="layernorm", act="gelu",
    attn_bias=True, rope_theta=100000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=144, vocab=512,
    head_dim=12, attn_chunk=64, loss_chunk=32, max_seq=512,
)
