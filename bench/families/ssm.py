"""The Mamba2 language model (``family: "ssm"``; reference
``bench/reference/ssm.py``), its published configuration in the terms of
the ``mamba_ssm`` code: ``config.json`` and the Mamba2 layer's and the
mixer model's defaults, which that file leaves to the code."""
from __future__ import annotations

from bench.harness import yardstick as Y

ARCH_KEYS = ("d_model", "n_layers", "vocab", "norm_eps", "tie_embeddings",
             "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv",
             "ssm_groups", "ssm_chunk")

COUNTERS = {
    "ssd_fwd": ("repro_torch.kernels.ssd_scan.ops", "ssd_scan"),
    "ssd_bwd": ("repro_torch.kernels.ssd_scan.ops", "ssd_scan_bwd")}


def published(src: dict) -> dict:
    """The embedding and the tied head have ``vocab_size`` rows padded to
    a multiple of ``pad_vocab_size_multiple``, as the published code
    builds them."""
    pad = src["pad_vocab_size_multiple"]
    layer, mixer = src["mamba2_defaults"], src["mixer_defaults"]
    return {"d_model": src["d_model"],
            "n_layers": src["n_layer"],
            "vocab": -(-src["vocab_size"] // pad) * pad,
            "tie_embeddings": src["tie_embeddings"],
            "norm_eps": mixer["norm_epsilon"],
            "ssm_state": layer["d_state"],
            "ssm_head_dim": layer["headdim"],
            "ssm_expand": layer["expand"],
            "ssm_conv": layer["d_conv"],
            "ssm_groups": layer["ngroups"],
            "ssm_chunk": layer["chunk_size"]}


def _sizes(m: dict) -> tuple:
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"]


def matmul_weights(m: dict) -> int:
    """Weights of every matmul a token passes through (each layer's in and
    out projections, the tied head), not the embedding lookup."""
    D = m["d_model"]
    di, heads = _sizes(m)
    N, G = m["ssm_state"], m["ssm_groups"]
    per_layer = D * (2 * di + 2 * G * N + heads) + di * D
    return m["n_layers"] * per_layer + D * m["vocab"]


def mixer_flops(m: dict, B: int, Sq: int, Sk: int, *, causal: bool) -> int:
    """Forward flops of every layer's SSD scan over one call, by the
    frozen work formula; a decode step (``Sq = 1``) is one recurrent
    step whatever the cached length."""
    di, heads = _sizes(m)
    chunk = m["ssm_chunk"] if Sq > 1 else 1
    w = Y.ssd_work(B, Sq, heads, m["ssm_head_dim"], m["ssm_state"], chunk)
    return m["n_layers"] * w["flops"]
