"""whisper-medium [audio]: enc-dec, conv frontend stubbed to precomputed
frames. 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig

WHISPER_MEDIUM = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,            # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    enc_layers=24,
    enc_seq=1500,           # 30 s of audio after the conv stub
    act="gelu",
    rope_theta=0.0,         # absolute positional embeddings, no RoPE
    microbatches=2,
    attn_impl="blocked",
    sp_prefill=True,
    skip_shapes=("long_500k",),   # pure full attention (DESIGN.md §4)
)
