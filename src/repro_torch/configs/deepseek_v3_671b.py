"""deepseek-v3-671b [moe] — 61L d7168 128H ffn(expert)=2048 vocab129280.

MLA (kv_lora 512 + rope 64, q_lora 1536), 1 shared + 256 routed experts
top-8 with sigmoid gating and aux-loss-free bias balancing; first 3 layers
dense (d_ff 18432); multi-token-prediction head (one extra block predicting
t+2, λ=0.1), which only training runs.  Prefill goes window by window,
4096 tokens at a time.  [arXiv:2412.19437; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab=129280, head_dim=128, norm="rmsnorm", act="swiglu",
    rope_theta=10000.0,
    mla={"q_lora_rank": 1536, "kv_lora_rank": 512,
         "qk_nope_dim": 128, "qk_rope_dim": 64, "v_head_dim": 128},
    moe={"n_experts": 256, "top_k": 8, "d_ff": 2048, "first_dense": 3,
         "router_type": "sigmoid_topk", "router_bias": True,
         "shared_expert": 1, "routed_scale": 2.5, "capacity_factor": 1.25,
         "aux_weight": 0.0},
    moe_sharding="ep",
    mtp=True, mtp_weight=0.1,
    prefill_chunk=4096,  # window-wise prefill
)

SMOKE = CONFIG.replace(
    prefill_chunk=None,  # CPU smoke tests exercise one-shot prefill
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, vocab=512, d_ff=128,
    head_dim=16, attn_chunk=64, loss_chunk=32, max_seq=512,
    mla={"q_lora_rank": 24, "kv_lora_rank": 16,
         "qk_nope_dim": 16, "qk_rope_dim": 8, "v_head_dim": 16},
    moe={"n_experts": 8, "top_k": 2, "d_ff": 32, "first_dense": 1,
         "router_type": "sigmoid_topk", "router_bias": True,
         "shared_expert": 1, "routed_scale": 2.5, "capacity_factor": 2.0,
         "aux_weight": 0.0},
)
