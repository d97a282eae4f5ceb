"""qwen3-1.7b [dense]: 28L d_model=2048 16H (kv=8) d_ff=6144
vocab=151936, qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

QWEN3_1_7B = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    microbatches=2,
    attn_impl="blocked",
    sp_prefill=True,
    skip_shapes=("long_500k",),
)
