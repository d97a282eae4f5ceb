"""Architecture and shape configuration schema (the port's own copy of
``repro.configs.base.ArchConfig`` and ``ShapeConfig``).

Every architecture the port serves or trains is an :class:`ArchConfig`;
every input shape a :class:`ShapeConfig`.  The fields and the derived
sizes are the reference's, so a configuration reads the same in both
packages; the distribution and compile knobs are kept as data (the port's
eager PyTorch path reads only ``remat`` and ``microbatches`` of them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # sliding-window pattern: number of local layers per global layer
    # (0 = all-global/full attention)
    local_per_global: int = 0
    local_window: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0        # fused shared-expert hidden size
    moe_dense_residual: bool = False
    d_ff_dense: int = 0         # parallel dense-residual FFN hidden size
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2): shared attention block every N blocks (0 = none)
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0            # precomputed audio frames (conv stub output)

    # VLM (internvl): precomputed vision patch embeddings (ViT stub output)
    vis_tokens: int = 0

    norm_eps: float = 1e-6
    act: str = "silu"           # silu (gated) | gelu (whisper-style)
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"  # AdamW moment dtype (bf16 for the giants)

    # distribution hints (baseline; the perf pass iterates on these)
    moe_strategy: str = "tp"    # "ep": experts over model axis; "tp": d_ff
    remat: str = "block"        # none | block | dots
    scan_layers: bool = True
    # §Perf knobs (baseline values; EXPERIMENTS.md §Perf flips them)
    attn_impl: str = "naive"    # naive | blocked (XLA online-softmax flash)
    attn_chunk: int = 1024      # KV chunk for the blocked path
    sp: bool = False            # sequence-parallel residual stream (TP-SP)
    sp_prefill: bool = False    # enable SP for prefill cells only (fwd-only
                                # SP wins; train SP was refuted — §Perf)
    accum_constraint: bool = False  # pin grad-accumulator sharding to params
    fused_qkv: bool = False     # one QKV projection: 1 bwd AR instead of 3
    fused_gate_up: bool = False  # one gate|up matmul: 1 bwd AR instead of 2
    ssm_proj_tp: bool = True    # shard mamba in/out_proj over the model
                                # axis (False: replicate — §Perf Z probe)
    # microbatches for grad accumulation at the production shapes
    microbatches: int = 1

    # shapes this arch must skip (with the reason recorded in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else (
            self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, K, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H * dh) + 2 * D * (K * dh) + (H * dh) * D
        dense_ffn = 3 * D * F
        per_layer = 0
        if self.family in ("dense", "encdec", "vlm"):
            per_layer = attn + dense_ffn + 2 * D
        elif self.family == "moe":
            moe = 3 * D * F * self.n_experts + D * self.n_experts
            if self.n_shared_experts:
                moe += 3 * D * self.d_ff_shared
            if self.moe_dense_residual:
                moe += 3 * D * self.d_ff_dense
            per_layer = attn + moe + 2 * D
        elif self.family == "ssm":
            per_layer = self._ssm_block_params() + D
        elif self.family == "hybrid":
            per_layer = self._ssm_block_params() + D
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn + 3 * D * F + 2 * D     # one shared attn+ffn block
        if self.family == "encdec":
            total += self.enc_layers * (attn + dense_ffn + 2 * D)
            total += self.n_layers * (attn + D)   # cross-attention
            total += (self.enc_seq + 8192) * D    # absolute pos tables
        total += V * D                            # embeddings
        if not self.tie_embeddings:
            total += V * D                        # lm head
        return total

    def _ssm_block_params(self) -> int:
        D, di = self.d_model, self.d_inner
        conv_dim = di + 2 * self.ssm_groups * self.ssm_state
        in_proj = D * (2 * di + 2 * self.ssm_groups * self.ssm_state
                       + self.ssm_heads)
        return (in_proj + self.ssm_conv * conv_dim + 3 * self.ssm_heads
                + di + di * D)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k of routed experts)."""
        if self.family != "moe":
            return self.n_params()
        D, F = self.d_model, self.d_ff
        routed_all = 3 * D * F * self.n_experts
        routed_active = 3 * D * F * self.top_k
        return self.n_params() - self.n_layers * (routed_all - routed_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs whose attention is pure full attention skip long_500k (quadratic
# history, no sub-quadratic structure)
FULL_ATTENTION_SKIP = ("long_500k",)
