"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig

QWEN2_MOE_A2_7B = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_shared=5632,       # 4 x 1408 fused shared expert
    qkv_bias=True,
    moe_strategy="tp",      # 60 % 16 != 0 -> shard expert d_ff instead
    microbatches=4,
    attn_impl="blocked",
    # sp_prefill measured at +406%% on prefill_32k: the seq-sharded
    # residual stream forces resharding around the MoE token-sort dispatch
    # (argsort/scatter over the flattened token dim) — kept OFF.
    sp_prefill=False,
    skip_shapes=("long_500k",),
)
