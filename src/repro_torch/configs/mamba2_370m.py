"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, ssm_state=128,
vocab=50280, SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

MAMBA2_370M = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,              # no attention; placeholder
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,        # 32 SSD heads
    ssm_chunk=128,
    tie_embeddings=True,
    microbatches=2,
    # long_500k RUNS: O(1) decode state.
)
