"""zamba2-7b [hybrid]: 81 blocks d_model=3584, Mamba2 backbone
(ssm_state=64) + SHARED attention block (32H kv=32, d_ff=14336) invoked
periodically with tied parameters. [arXiv:2411.15242; unverified]"""
from .base import ArchConfig

ZAMBA2_7B = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,             # shared block FFN
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,        # 112 SSD heads
    ssm_chunk=128,
    shared_attn_every=6,
    microbatches=4,
    attn_impl="blocked",
    sp_prefill=True,
    # long_500k RUNS: bounded SSM state; shared attn layers decode O(seq).
)
