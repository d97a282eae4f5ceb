"""Architecture registry of the port: the reference's ten archs and the
reduced ("tiny") variants that drive the CPU tests (the port's own copy of
``repro.configs.registry.get_arch``/``tiny``).

Every family is here: dense (qwen2-7b, qwen3-1.7b, qwen1.5-32b,
gemma3-27b), moe (qwen2-moe-a2.7b, arctic-480b), ssm (mamba2-370m),
hybrid (zamba2-7b), encdec (whisper-medium) and vlm (internvl2-26b).
"""
from __future__ import annotations

import dataclasses

from .arctic_480b import ARCTIC_480B
from .base import SHAPES, ArchConfig
from .gemma3_27b import GEMMA3_27B
from .internvl2_26b import INTERNVL2_26B
from .mamba2_370m import MAMBA2_370M
from .qwen1_5_32b import QWEN1_5_32B
from .qwen2_7b import QWEN2_7B
from .qwen2_moe_a2_7b import QWEN2_MOE_A2_7B
from .qwen3_1_7b import QWEN3_1_7B
from .whisper_medium import WHISPER_MEDIUM
from .zamba2_7b import ZAMBA2_7B

ARCHS = {c.name: c for c in (
    WHISPER_MEDIUM, ARCTIC_480B, QWEN2_MOE_A2_7B, GEMMA3_27B, QWEN3_1_7B,
    QWEN1_5_32B, QWEN2_7B, MAMBA2_370M, INTERNVL2_26B, ZAMBA2_7B,
)}


def get_arch(name: str) -> ArchConfig:
    """A registered arch by name, or ``tiny:NAME`` for its reduced form."""
    if name.startswith("tiny:"):
        return tiny(ARCHS[name[5:]])
    return ARCHS[name]


def cells():
    """All (arch, shape, skip) dry-run cells, the documented skips
    included."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            skip = shape.name in arch.skip_shapes
            # every arch has a decoder: only the long_500k rule applies
            out.append((arch, shape, skip))
    return out


def tiny(arch: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(arch.n_layers, 4 if arch.family != "hybrid" else 7),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads < arch.n_heads
        else 4,
        d_head=32,
        d_ff=256,
        vocab=512,
        param_dtype="float32",
        compute_dtype="float32",
        scan_layers=arch.scan_layers,
        microbatches=1,
    )
    if arch.n_experts:
        small.update(n_experts=8, top_k=min(arch.top_k, 2),
                     d_ff=64,
                     d_ff_shared=128 if arch.n_shared_experts else 0,
                     d_ff_dense=128 if arch.moe_dense_residual else 0,
                     # capacity >= T*k at smoke sizes: no token drops, so
                     # prefill/decode consistency is exact
                     capacity_factor=8.0)
    if arch.ssm_state:
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if arch.enc_layers:
        small.update(enc_layers=2, enc_seq=24)
    if arch.vis_tokens:
        small.update(vis_tokens=8)
    if arch.shared_attn_every:
        small.update(shared_attn_every=3)
    if arch.local_per_global:
        small.update(local_per_global=arch.local_per_global, local_window=16)
    small.update(overrides)
    return dataclasses.replace(arch, **small)
