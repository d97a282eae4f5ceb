"""The dense decoder with grouped-query attention (``family: "dense"``;
reference ``bench/reference/dense.py``), its published configuration in
Hugging Face ``transformers`` terms."""
from __future__ import annotations

from bench.harness import yardstick as Y

ARCH_KEYS = ("d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim",
             "d_ff", "vocab", "rope_theta", "norm_eps", "qk_norm",
             "tie_embeddings")

COUNTERS = {
    "flash_fwd": ("repro_torch.kernels.flash_attention.ops",
                  "flash_attention"),
    "flash_bwd": ("repro_torch.kernels.flash_attention.ops",
                  "flash_attention_bwd")}

# ``model_type``s whose attention normalises each head's query and key
QK_NORM_TYPES = ("qwen3",)


def published(src: dict) -> dict:
    return {"d_model": src["hidden_size"],
            "n_layers": src["num_hidden_layers"],
            "n_heads": src["num_attention_heads"],
            "n_kv_heads": src["num_key_value_heads"],
            "head_dim": src["head_dim"],
            "d_ff": src["intermediate_size"],
            "vocab": src["vocab_size"],
            "rope_theta": src["rope_theta"],
            "norm_eps": src["rms_norm_eps"],
            "qk_norm": src["model_type"] in QK_NORM_TYPES,
            "tie_embeddings": src["tie_word_embeddings"],
            "embed_std": src["initializer_range"],
            "dtype": src["torch_dtype"]}


def matmul_weights(m: dict) -> int:
    """Weights of every matmul a token passes through, the output head
    included (tied or not) and the embedding lookup not."""
    D, H, K, dh, F = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                      m["head_dim"], m["d_ff"])
    per_layer = D * H * dh + 2 * D * K * dh + H * dh * D + 3 * D * F
    return m["n_layers"] * per_layer + D * m["vocab"]


def mixer_flops(m: dict, B: int, Sq: int, Sk: int, *, causal: bool) -> int:
    """Forward flops of every layer's attention over one call, by the
    frozen work formula; a decode step is ``Sq = 1`` against ``Sk``
    cached positions."""
    w = Y.flash_work(B, Sq, Sk, m["n_heads"], m["n_kv_heads"],
                     m["head_dim"], causal=causal)
    return m["n_layers"] * w["flops"]
