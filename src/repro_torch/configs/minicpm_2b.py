"""minicpm-2b [dense] — 40L d2304 36H (kv=36 ≡ MHA) ffn5760 vocab122753.

μP-style scaling (scale_emb=12, residual scale 1.4/√L, logits scaled by
256/d_model) and the WSD learning-rate schedule (see repro.optim.schedules).
Architecture is llama-like.  [arXiv:2404.06395; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64, norm="rmsnorm", act="swiglu",
    rope_theta=10000.0, tie_embeddings=True,
    scale_emb=12.0, scale_depth=1.4, logit_scale=256.0 / 2304.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=509,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
    logit_scale=256.0 / 64.0,
)
