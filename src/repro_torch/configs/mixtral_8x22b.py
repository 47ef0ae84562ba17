"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) ffn16384, 8 experts top-2.

Sliding-window attention (window 4096 per the assignment spec) makes the
long_500k decode cell sub-quadratic (ring-buffer KV cache of the window).
Experts < |model| ⇒ MoE hidden dims are TP-sharded (moe_sharding="tp").
[arXiv:2401.04088; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128, norm="rmsnorm", act="swiglu",
    rope_theta=1000000.0, window=4096,
    moe={"n_experts": 8, "top_k": 2, "d_ff": 16384, "first_dense": 0,
         "router_type": "softmax_topk", "capacity_factor": 1.25,
         "aux_weight": 0.01},
    moe_sharding="tp",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, window=64, attn_chunk=64, loss_chunk=32, max_seq=512,
    moe={"n_experts": 4, "top_k": 2, "d_ff": 64, "first_dense": 0,
         "router_type": "softmax_topk", "capacity_factor": 2.0,
         "aux_weight": 0.01},
)
