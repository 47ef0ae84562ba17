"""mamba2-130m [ssm] — 24L d768 (attn-free) ssm_state=128 vocab50280.

SSD (state-space duality) blocks: d_inner 1536, head_dim 64 (24 heads),
conv width 4, chunk 128.  Attention-free ⇒ decode state is O(1) in sequence
length, so all four shapes including long_500k run.  ``shard_ssm_heads``
is the JAX package's hint that 24 heads do not divide its 16-way model
axis; one card shards nothing.  [arXiv:2405.21060]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab=50280, head_dim=64, norm="rmsnorm", act="swiglu",
    rope_theta=None, tie_embeddings=True,
    ssm={"d_inner": 1536, "d_state": 128, "head_dim": 64, "d_conv": 4,
         "n_groups": 1, "chunk": 128},
    shard_ssm_heads=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, loss_chunk=32, max_seq=512,
    ssm={"d_inner": 128, "d_state": 16, "head_dim": 32, "d_conv": 4,
         "n_groups": 1, "chunk": 32},
)
