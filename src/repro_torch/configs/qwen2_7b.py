"""qwen2-7b [dense]: 28L d_model=3584 28H (kv=4) d_ff=18944
vocab=152064, GQA + QKV bias. [arXiv:2407.10671; hf]"""
from .base import ArchConfig

QWEN2_7B = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    microbatches=4,
    attn_impl="blocked",
    sp_prefill=True,
    skip_shapes=("long_500k",),
)
