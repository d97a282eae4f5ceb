"""gemma3-27b [dense]: 62L d_model=5376 32H (kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig

GEMMA3_27B = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262144,
    qk_norm=True,
    local_per_global=5,
    local_window=1024,
    rope_theta=1e6,
    microbatches=4,           # §Perf A7
    attn_impl="blocked",
    sp_prefill=True,
    # long_500k RUNS: 5/6 of layers are bounded-window; global layers
    # decode O(seq) against a sharded cache (DESIGN.md §4).
)
