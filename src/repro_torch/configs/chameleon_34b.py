"""chameleon-34b [vlm] — 48L d8192 64H (GQA kv=8) ffn22016 vocab65536.

Early-fusion VLM: VQ image tokens share the 65536-entry vocabulary with
text, so the backbone sees one mixed token stream — the modality frontend
(VQ-GAN tokenizer) is a STUB per the assignment; ``input_specs()`` provides
token ids.  q/k-norm for training stability.  [arXiv:2405.09818]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, qk_norm=True,
    norm="rmsnorm", act="swiglu", rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
)
