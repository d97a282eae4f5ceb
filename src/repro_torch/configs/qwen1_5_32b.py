"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig

QWEN1_5_32B = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    microbatches=8,
    attn_impl="blocked",  # §Perf B1: -97%% memory term
    sp_prefill=True,       # §Perf B3
    skip_shapes=("long_500k",),
)
