"""Layer stacks for every family (port of ``repro.models.transformer``):

  * dense / vlm:  [attn -> mlp] x L, with gemma3's local:global window
    pattern;
  * moe:          [attn -> moe_ffn (+shared / +dense residual)] x L;
  * ssm:          [mamba2 SSD] x L;
  * hybrid:       mamba2 backbone with the tied shared block every k-th
    layer (zamba2);
  * encdec:       bidirectional encoder stack + causal decoder stack with
    cross-attention (whisper).

The reference scans over stacked per-layer parameters with ``lax.scan``,
computes each layer's window as a traced scalar, and picks zamba2's
shared block with ``lax.cond`` and a dynamic cache index.  Here each stack
is a Python loop over the per-layer parameter trees: dense layer ``idx``
attends with :func:`_layer_window`'s window and cache slot ``idx``;
hybrid layer ``idx`` runs the tied shared block after its Mamba2 block
when ``idx % k == k - 1``, with attention cache slot ``idx // k``.  Caches
are stacked tensors updated in place.  In training each layer runs under
:func:`_maybe_remat`, the reference's activation checkpointing.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .layers import _zeros, attn_params, cross_attention, cross_kv, mlp, \
    mlp_params, rms_norm, self_attention
from .mamba2 import SSMCache, init_ssm_cache, mamba_block
from .moe import moe_ffn, moe_params


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


def moe_block(p, x: torch.Tensor, cfg, *, positions, mode: str,
              cache: Optional[dict] = None, cache_pos=None):
    h, new_cache = self_attention(p["attn"], rms_norm(x, p["ln1"],
                                                      cfg.norm_eps),
                                  cfg, positions=positions, mode=mode,
                                  cache=cache, cache_pos=cache_pos)
    x = x + h
    y, aux = moe_ffn(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, new_cache, aux


def encdec_block(p, x: torch.Tensor, cfg, *, positions, mode: str,
                 cache: Optional[dict] = None, cache_pos=None,
                 enc_out: Optional[torch.Tensor] = None,
                 xa_cache: Optional[dict] = None):
    """Whisper's decoder block: causal self-attention, cross-attention
    over ``enc_out`` (prefill) or ``xa_cache`` (decode), MLP.  Returns
    (x, cache, the cross k/v)."""
    h, new_cache = self_attention(p["attn"], rms_norm(x, p["ln1"],
                                                      cfg.norm_eps),
                                  cfg, positions=positions, mode=mode,
                                  cache=cache, cache_pos=cache_pos)
    x = x + h
    h, xa_kv = cross_attention(p["xattn"], rms_norm(x, p["ln_x"],
                                                    cfg.norm_eps),
                               cfg, kv=enc_out, kv_cache=xa_cache)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return x, new_cache, xa_kv


def dense_block_params(gen: torch.Generator, cfg, dtype) -> dict:
    return {"ln1": _zeros(gen, (cfg.d_model,), dtype),
            "ln2": _zeros(gen, (cfg.d_model,), dtype),
            "attn": attn_params(gen, cfg, dtype),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, cfg.act,
                              fused=cfg.fused_gate_up)}


def moe_block_params(gen: torch.Generator, cfg, dtype) -> dict:
    return {"ln1": _zeros(gen, (cfg.d_model,), dtype),
            "ln2": _zeros(gen, (cfg.d_model,), dtype),
            "attn": attn_params(gen, cfg, dtype),
            "moe": moe_params(gen, cfg, dtype)}


def encdec_block_params(gen: torch.Generator, cfg, dtype) -> dict:
    return {"ln1": _zeros(gen, (cfg.d_model,), dtype),
            "ln2": _zeros(gen, (cfg.d_model,), dtype),
            "ln_x": _zeros(gen, (cfg.d_model,), dtype),
            "attn": attn_params(gen, cfg, dtype),
            "xattn": attn_params(gen, cfg, dtype),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, cfg.act,
                              fused=cfg.fused_gate_up)}


def _layer_window(cfg, idx: int) -> int:
    """Sliding-window size of layer ``idx`` (0 = full attention): with
    ``local_per_global`` local layers per global one, every
    ``local_per_global + 1``-th layer is global."""
    if not cfg.local_per_global:
        return 0
    period = cfg.local_per_global + 1
    return 0 if idx % period == period - 1 else cfg.local_window


def _maybe_remat(cfg, fn: Callable, x: torch.Tensor):
    """``fn(x)``, one layer of a stack, under activation checkpointing when
    it trains (grad enabled and ``x`` needs a gradient) and ``cfg.remat``
    asks for it: the reference's ``_maybe_remat``.  Only the layer's input
    is kept; its forward runs again in the backward, through the same
    kernels, so the recomputed activations are the same bits.  ``"dots"``
    (the reference saves the matmul outputs) behaves as ``"block"`` here:
    it changes memory, not values.  Serving (no gradient) calls ``fn``
    as it is."""
    if cfg.remat in ("block", "dots") and torch.is_grad_enabled() \
            and x.requires_grad:
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _layer_cache(caches: Optional[dict], idx: int) -> Optional[dict]:
    """Layer ``idx``'s {'k','v'} views of stacked [L, ...] caches."""
    return None if caches is None else {"k": caches["k"][idx],
                                        "v": caches["v"][idx]}


def dense_stack(params, x: torch.Tensor, cfg, *, positions, mode: str,
                caches: Optional[dict] = None, cache_pos=None):
    """[attn -> mlp] x L.  ``params`` holds the L per-layer trees;
    ``caches = {'k','v'} [L, B, max_len, K, dh]`` or None, updated in
    place and returned."""
    for idx, lp in enumerate(params):
        x = _maybe_remat(cfg, lambda x, lp=lp, idx=idx: dense_block(
            lp, x, cfg, positions=positions, mode=mode,
            window=_layer_window(cfg, idx), cache=_layer_cache(caches, idx),
            cache_pos=cache_pos)[0], x)
    return x, caches


def moe_stack(params, x: torch.Tensor, cfg, *, positions, mode: str,
              caches: Optional[dict] = None, cache_pos=None):
    """[attn -> moe_ffn] x L; returns (x, caches, the mean aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, lp in enumerate(params):
        x, _, a = _maybe_remat(cfg, lambda x, lp=lp, idx=idx: moe_block(
            lp, x, cfg, positions=positions, mode=mode,
            cache=_layer_cache(caches, idx), cache_pos=cache_pos), x)
        aux = aux + a
    return x, caches, aux / len(params)


def _ssm_layer_cache(caches: Optional[SSMCache], idx: int):
    return None if caches is None else SSMCache(caches.state[idx],
                                                caches.conv[idx])


def _mamba_layer(lp, x: torch.Tensor, cfg, ssm: Optional[SSMCache]):
    """x + mamba_block(rms_norm(x)), the layer's cache views updated in
    place."""
    h, new = mamba_block(lp, rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                         cache=ssm)
    if new is not None:
        ssm.state.copy_(new.state)
        ssm.conv.copy_(new.conv)
    return x + h


def ssm_stack(params, x: torch.Tensor, cfg, *,
              caches: Optional[SSMCache] = None):
    """[mamba2 SSD] x L; ``caches`` an SSMCache of [L, ...] tensors or
    None, updated in place and returned."""
    for idx, lp in enumerate(params):
        x = _maybe_remat(cfg, lambda x, lp=lp, idx=idx: _mamba_layer(
            lp, x, cfg, _ssm_layer_cache(caches, idx)), x)
    return x, caches


def hybrid_stack(params, x: torch.Tensor, cfg, *, positions, mode: str,
                 caches: Optional[dict] = None, cache_pos=None):
    """zamba2: Mamba2 backbone + the tied shared block every k-th layer.

    ``params["mamba"]`` holds the L per-layer trees, ``params["shared"]``
    the shared block's; ``caches = {"ssm": SSMCache of [L, ...] tensors,
    "attn": {'k','v'} [n_inv, B, max_len, K, dh]}`` or None.  The caches
    are updated in place and returned."""
    k = cfg.shared_attn_every
    shared = params["shared"]

    def layer(x, lp, idx):
        x = _mamba_layer(lp, x, cfg, None if caches is None
                         else _ssm_layer_cache(caches["ssm"], idx))
        if k and idx % k == k - 1:
            attn = None if caches is None else \
                _layer_cache(caches["attn"], idx // k)
            x, _ = dense_block(shared, x, cfg, positions=positions,
                               mode=mode, cache=attn, cache_pos=cache_pos)
        return x
    for idx, lp in enumerate(params["mamba"]):
        x = _maybe_remat(cfg, lambda x, lp=lp, idx=idx: layer(x, lp, idx), x)
    return x, caches


def encoder_stack(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The bidirectional encoder: dense blocks without positions or
    caches."""
    for lp in params:
        x = _maybe_remat(cfg, lambda x, lp=lp: dense_block(
            lp, x, cfg, positions=None, mode="bidir")[0], x)
    return x


def decoder_stack(params, x: torch.Tensor, cfg, *, positions, mode: str,
                  enc_out: Optional[torch.Tensor] = None,
                  xa_caches: Optional[dict] = None,
                  caches: Optional[dict] = None, cache_pos=None):
    """Whisper's decoder; returns (x, caches, xa_caches).

    With ``enc_out`` (prefill) each layer projects its cross k/v from the
    encoder output; they are written into ``xa_caches`` ({'k','v'}
    [L, B, Se, K, dh] buffers) when given, else stacked into new ones.
    Without it (decode) each layer attends over its slot of
    ``xa_caches``.  ``caches`` are the self-attention caches; all are
    updated in place."""
    kvs = []
    for idx, lp in enumerate(params):
        xa = None if enc_out is not None else _layer_cache(xa_caches, idx)
        x, _, xa_kv = _maybe_remat(cfg, lambda x, lp=lp, idx=idx, xa=xa:
                                   encdec_block(
            lp, x, cfg, positions=positions, mode=mode,
            cache=_layer_cache(caches, idx), cache_pos=cache_pos,
            enc_out=enc_out, xa_cache=xa), x)
        if enc_out is not None and xa_caches is not None:
            xa_caches["k"][idx] = xa_kv["k"]
            xa_caches["v"][idx] = xa_kv["v"]
        elif enc_out is not None:
            kvs.append(xa_kv)
    if kvs:
        xa_caches = {n: torch.stack([kv[n] for kv in kvs]) for n in "kv"}
    return x, caches, xa_caches


def precompute_cross_caches(params, enc_out: torch.Tensor, cfg) -> dict:
    """[L]-stacked cross-attention k/v of the encoder output."""
    kvs = [cross_kv(lp["xattn"], enc_out, cfg) for lp in params]
    return {n: torch.stack([kv[n] for kv in kvs]) for n in "kv"}


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
