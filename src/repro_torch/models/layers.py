"""Neural net layers: norms, rotary embeddings, attention (GQA, qk-norm,
bias, sliding window, bidirectional, cross), MLPs (gated silu, gelu,
fused projections) and their initialisers (port of
``repro.models.layers``).

Every ``apply`` function takes a parameter mapping ``p`` (a
:class:`~repro_torch.models.model.ParamTree` or a dict) with the
reference's names.  Prompt attention -- causal prefill, the encoder's
bidirectional self-attention and the decoder's cross-attention over the
encoder output -- runs through the ``flash_attention`` kernel wrapper
(the Hopper kernel on a CUDA tensor, its plain version on a CPU one),
where the reference computes the same functions in jnp
(``attention_blocked``, ``attention_scores``).  Decode attends one query
against the KV cache, or the precomputed cross k/v, in plain PyTorch, as
the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + w`` (zero-initialised weights)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def head_rms_norm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim of [..., heads, head_dim]."""
    return rms_norm(x, w, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding by halves (not interleaved pairs).
    x: [B, S, H, dh]; positions: [B, S] (int).  ``theta <= 0`` means no
    rotary embedding (absolute positions, as whisper's): x as it is."""
    if theta <= 0.0:
        return x
    half = x.shape[-1] // 2
    f32 = torch.float32
    log_theta = torch.log(torch.tensor(theta, dtype=f32))
    freq = torch.exp(-log_theta * torch.arange(0, half, dtype=f32,
                                               device=x.device) / half)
    ang = positions[..., None].to(f32) * freq              # [B,S,half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def qkv(p, x: torch.Tensor, cfg, positions: Optional[torch.Tensor], *,
        use_rope: bool = True):
    """Project to q [B,S,H,dh] and k/v [B,S,K,dh] (GQA layout), in one
    product where the parameters are fused (``wqkv``/``bqkv``)."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in p:
        u = _proj(x, p["wqkv"], p.get("bqkv"))
        # the kernels take contiguous q/k/v, which slices of u are not
        q, k, v = torch.split(u, [H * dh, K * dh, K * dh], dim=-1)
        q = q.reshape(B, S, H, dh).contiguous()
        k = k.reshape(B, S, K, dh).contiguous()
        v = v.reshape(B, S, K, dh).contiguous()
    else:
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, dh)
        k = _proj(x, p["wk"], p.get("bk")).reshape(B, S, K, dh)
        v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """GQA attention in plain PyTorch.  q: [B,Sq,H,dh], k/v: [B,Sk,K,dh],
    mask broadcastable to [B,1,Sq,Sk] (True = attend).  Returns
    [B,Sq,H,dh].  As in the reference, the scores are divided by
    ``sqrt(dh)`` rounded to the q dtype, in the q dtype, before the f32
    softmax, and the weights are cast back to the q dtype."""
    H, dh = q.shape[2], q.shape[3]
    K = k.shape[2]
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    root = float(torch.tensor(math.sqrt(dh)).to(q.dtype))
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) / root
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def self_attention(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                   mode: str = "causal", window: int = 0,
                   cache: Optional[dict] = None, cache_pos=None):
    """Self-attention; returns (out, cache).

    ``mode="causal"`` (prefill) attends over the current tokens through
    ``flash_attention`` and, given a ``cache`` ({'k','v'} buffers
    [B, S_max, K, dh]), fills it from position 0.  ``mode="bidir"`` (the
    encoder) attends over every token through ``flash_attention`` without
    a mask and keeps no cache.  ``mode="decode"`` (one new token) writes
    its k/v at ``cache_pos`` and attends over the cache.  The cache
    buffers are updated in place (the reference returns new arrays), so a
    caller's stacked cache needs no copy back.
    """
    B, S, _ = x.shape
    q, k, v = qkv(p, x, cfg, positions)
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        pos = int(cache_pos)
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        kpos = torch.arange(cache["k"].shape[1], device=x.device)
        m = kpos <= pos
        if window > 0:
            m = m & (kpos > pos - window)
        out = attention_scores(q, cache["k"], cache["v"],
                               m[None, None, None, :])
    elif mode == "causal":
        out = flash_attention(q, k, v, causal=True, window=window)
        if cache is not None:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    elif mode == "bidir":
        out = flash_attention(q, k, v, causal=False)
        cache = None
    else:
        raise ValueError(f"attention mode {mode!r}")
    Sq, H, dh = out.shape[1:]
    y = out.reshape(B, Sq, H * dh) @ p["wo"].to(x.dtype)
    return y, cache


def cross_attention(p, x: torch.Tensor, cfg, *,
                    kv: Optional[torch.Tensor] = None,
                    kv_cache: Optional[dict] = None):
    """Decoder cross-attention over the encoder output; returns (out,
    {'k','v'}).

    ``kv``: the encoder activations [B, Se, D] (prefill), projected here
    and attended through ``flash_attention`` without a mask (Sq != Se);
    ``kv_cache``: the precomputed {'k','v'} [B, Se, K, dh] (decode),
    attended in plain PyTorch."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, dh)
    if kv_cache is None:
        kv_cache = cross_kv(p, kv, cfg)
        out = flash_attention(q, kv_cache["k"], kv_cache["v"], causal=False)
    else:
        out = attention_scores(q, kv_cache["k"], kv_cache["v"], None)
    y = out.reshape(B, S, H * dh) @ p["wo"].to(x.dtype)
    return y, kv_cache


def cross_kv(p, kv: torch.Tensor, cfg) -> dict:
    """The cross-attention k/v [B, Se, K, dh] of the encoder output (no
    bias, as in the reference)."""
    B, Se, _ = kv.shape
    K, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": _proj(kv, p["wk"]).reshape(B, Se, K, dh),
            "v": _proj(kv, p["wv"]).reshape(B, Se, K, dh)}


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """gelu (tanh approximation, ``jax.nn.gelu``'s default) of one
    up-projection, or the gated silu, fused (``w_gate_up``) or not."""
    if act == "gelu":
        h = F.gelu(_proj(x, p["w_up"]), approximate="tanh")
    elif "w_gate_up" in p:
        g, u = torch.chunk(_proj(x, p["w_gate_up"]), 2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.silu(_proj(x, p["w_gate"])) * _proj(x, p["w_up"])
    return h @ p["w_down"].to(x.dtype)


# --------------------------------------------------------------------- #
# initialisers: the reference's scales, from a torch.Generator            #
# --------------------------------------------------------------------- #
class ShapesOnly:
    """Stands for the generator where only shapes and dtypes are wanted
    (the dry-run's cells): the initialisers make meta tensors, which hold
    no data (no generator exists on the meta device)."""
    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (default ``fan_in ** -0.5``, fan-in the
    first dim) drawn in f32 on the generator's device, then cast.  The
    scale is applied in place, so the f32 draw is the only temporary (an
    arctic-480b expert leaf's is 17.8 GB).  On the meta device
    (:class:`ShapesOnly`) an empty tensor of the shape and dtype."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    scale = scale if scale is not None else shape[0] ** -0.5
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def attn_params(gen: torch.Generator, cfg, dtype) -> dict:
    H, K, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    if cfg.fused_qkv:
        p = {"wqkv": dense_init(gen, (D, (H + 2 * K) * dh), dtype),
             "wo": dense_init(gen, (H * dh, D), dtype,
                              scale=(H * dh) ** -0.5)}
        if cfg.qkv_bias:
            p["bqkv"] = _zeros(gen, ((H + 2 * K) * dh,), dtype)
        if cfg.qk_norm:
            p.update(q_norm=_zeros(gen, (dh,), dtype),
                     k_norm=_zeros(gen, (dh,), dtype))
        return p
    p = {
        "wq": dense_init(gen, (D, H * dh), dtype),
        "wk": dense_init(gen, (D, K * dh), dtype),
        "wv": dense_init(gen, (D, K * dh), dtype),
        "wo": dense_init(gen, (H * dh, D), dtype, scale=(H * dh) ** -0.5),
    }
    if cfg.qkv_bias:
        p.update(bq=_zeros(gen, (H * dh,), dtype),
                 bk=_zeros(gen, (K * dh,), dtype),
                 bv=_zeros(gen, (K * dh,), dtype))
    if cfg.qk_norm:
        p.update(q_norm=_zeros(gen, (dh,), dtype),
                 k_norm=_zeros(gen, (dh,), dtype))
    return p


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
               act: str = "silu", fused: bool = False) -> dict:
    """gelu: ``w_up``/``w_down``; silu: ``w_gate``/``w_up``/``w_down``,
    or ``w_gate_up``/``w_down`` when ``fused``."""
    if act == "gelu":
        p = {"w_up": dense_init(gen, (d_model, d_ff), dtype)}
    elif fused:
        p = {"w_gate_up": dense_init(gen, (d_model, 2 * d_ff), dtype)}
    else:
        p = {"w_gate": dense_init(gen, (d_model, d_ff), dtype),
             "w_up": dense_init(gen, (d_model, d_ff), dtype)}
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype, scale=d_ff ** -0.5)
    return p
