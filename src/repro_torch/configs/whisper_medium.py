"""whisper-medium [audio] — enc-dec, 24+24L d1024 16H ffn4096 vocab51865.

The conv frontend is a stub, as in the JAX package: the serve driver
supplies frame embeddings [B, 1500, d_model] drawn from its seed; the
transformer backbone (bidirectional encoder + causal decoder with
cross-attention) is real.  The decoder uses learned positions, the
encoder sinusoidal ones.  [arXiv:2212.04356]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, norm="layernorm", act="gelu",
    pos_emb="learned", rope_theta=None, attn_bias=True,
    encdec={"enc_layers": 24, "enc_frames": 1500},
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
    encdec={"enc_layers": 2, "enc_frames": 30},
)
