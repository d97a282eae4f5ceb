"""internvl2-26b [vlm]: InternLM2-20b backbone, 48L d_model=6144 48H (kv=8)
d_ff=16384 vocab=92553; InternViT frontend is a stub providing precomputed
patch embeddings. [arXiv:2404.16821; hf]"""
from .base import ArchConfig

INTERNVL2_26B = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92553,
    vis_tokens=256,         # ViT stub output per image
    microbatches=8,
    attn_impl="blocked",
    sp_prefill=True,
    skip_shapes=("long_500k",),
)
