"""arctic-480b [moe]: 35L d_model=7168 56H (kv=8) expert d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ArchConfig

ARCTIC_480B = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,              # per-expert hidden
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    d_ff_dense=4864,
    moe_strategy="ep",      # 128 experts / 16 model shards = 8 per shard
    opt_dtype="bfloat16",   # fits-notes in EXPERIMENTS.md §Dry-run
    microbatches=8,           # §Perf C2
    attn_impl="blocked",
    accum_constraint=True,    # §Perf C1
    sp_prefill=True,
    skip_shapes=("long_500k",),
)
