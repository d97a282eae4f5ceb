"""Layer stacks (port of ``repro.models.transformer`` for the hybrid
family): the dense block, its parameters, the zamba2 stack and the
functions that allocate its caches.

The reference scans over stacked per-layer parameters with ``lax.scan``
and picks the shared block with ``lax.cond`` and a dynamic cache index.
Here the stack is a Python loop over the per-layer parameter trees: layer
``idx`` runs the tied shared block after its Mamba2 block when
``idx % k == k - 1``, with attention cache slot ``idx // k``.  Caches are
stacked tensors updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import _zeros, attn_params, mlp, mlp_params, rms_norm, \
    self_attention
from .mamba2 import SSMCache, init_ssm_cache, mamba_block


def dense_block(p, x: torch.Tensor, cfg, *, positions, mode: str,
                window: int = 0, cache: Optional[dict] = None,
                cache_pos=None):
    h, new_cache = self_attention(p["attn"], rms_norm(x, p["ln1"],
                                                      cfg.norm_eps),
                                  cfg, positions=positions, mode=mode,
                                  window=window, cache=cache,
                                  cache_pos=cache_pos)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return x, new_cache


def dense_block_params(gen: torch.Generator, cfg, dtype) -> dict:
    return {"ln1": _zeros(gen, (cfg.d_model,), dtype),
            "ln2": _zeros(gen, (cfg.d_model,), dtype),
            "attn": attn_params(gen, cfg, dtype),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, cfg.act,
                              fused=cfg.fused_gate_up)}


def hybrid_stack(params, x: torch.Tensor, cfg, *, positions, mode: str,
                 caches: Optional[dict] = None, cache_pos=None):
    """zamba2: Mamba2 backbone + the tied shared block every k-th layer.

    ``params["mamba"]`` holds the L per-layer trees, ``params["shared"]``
    the shared block's; ``caches = {"ssm": SSMCache of [L, ...] tensors,
    "attn": {'k','v'} [n_inv, B, max_len, K, dh]}`` or None.  The caches
    are updated in place and returned."""
    k = cfg.shared_attn_every
    shared = params["shared"]
    for idx, lp in enumerate(params["mamba"]):
        ssm = None if caches is None else SSMCache(
            caches["ssm"].state[idx], caches["ssm"].conv[idx])
        h, new_ssm = mamba_block(lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                                 cfg, cache=ssm)
        x = x + h
        if new_ssm is not None:
            ssm.state.copy_(new_ssm.state)
            ssm.conv.copy_(new_ssm.conv)
        if k and idx % k == k - 1:
            inv = idx // k
            attn = None if caches is None else {
                "k": caches["attn"]["k"][inv], "v": caches["attn"]["v"][inv]}
            x, _ = dense_block(shared, x, cfg, positions=positions,
                               mode=mode, cache=attn, cache_pos=cache_pos)
    return x, caches


def init_attn_caches(cfg, n_layers: int, batch: int, max_len: int, dtype,
                     device) -> dict:
    K, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, batch, max_len, K, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ssm_caches(cfg, n_layers: int, batch: int, dtype,
                    device) -> SSMCache:
    one = init_ssm_cache(cfg, batch, dtype, device)
    return SSMCache(*(a[None].repeat((n_layers,) + (1,) * a.dim())
                      for a in one))
