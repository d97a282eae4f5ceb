"""Mamba2 block, SSD in the chunked matmul form (port of
``repro.models.mamba2``).

Block layout (Mamba2 paper): in_proj -> [z (gate), xBC (conv features),
dt]; causal depthwise conv on xBC; SSD; gated RMSNorm; out_proj.

The SSD of a prompt (no cache, or prefill into a cache) runs through the
``ssd_scan`` kernel wrapper (the Hopper kernel on a CUDA tensor, the
chunked plain version on a CPU one), where the reference computes the same
function in jnp (``ssd_chunked``).  The one-token decode step is the plain
recurrence, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .layers import _zeros, dense_init, rms_norm


class SSMCache(NamedTuple):
    state: torch.Tensor     # [B, H, P, N] carried SSD state
    conv: torch.Tensor      # [B, ck-1, conv_dim] conv tail


def _conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) for every x, as ``jax.nn.softplus`` computes it
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_params(gen: torch.Generator, cfg, dtype) -> dict:
    D, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    cdim = _conv_dim(cfg)
    f32 = torch.float32
    return {
        "ln": _zeros(gen, (D,), dtype),             # pre-norm (residual)
        # in_proj emits [z (di), xBC (cdim), dt (H)]
        "in_proj": dense_init(gen, (D, di + cdim + H), dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, cdim), dtype, scale=0.5),
        "conv_b": _zeros(gen, (cdim,), dtype),
        "A_log": _zeros(gen, (H,), f32),            # A = -exp(A_log) = -1
        "D": torch.ones((H,), dtype=f32, device=gen.device),
        "dt_bias": _zeros(gen, (H,), f32),
        "out_norm": _zeros(gen, (di,), dtype),
        "out_proj": dense_init(gen, (di, D), dtype, scale=di ** -0.5),
    }


def _split_proj(p, x: torch.Tensor, cfg):
    """in_proj -> z [B,S,di], xBC [B,S,cdim], dt [B,S,H]."""
    di = cfg.d_inner
    cdim = _conv_dim(cfg)
    u = x @ p["in_proj"].to(x.dtype)
    return u[..., :di], u[..., di:di + cdim], u[..., di + cdim:]


def _causal_conv(p, u: torch.Tensor, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv (kernel ck) by shift-and-add.

    u: [B,S,cdim]; tail: [B,ck-1,cdim] previous inputs (decode) or None
    (zero history).  Returns (y, new_tail), the tail being the last ck-1
    inputs."""
    w = p["conv_w"].to(u.dtype)                     # [ck, cdim]
    ck = w.shape[0]
    B, S, cdim = u.shape
    if tail is None:
        tail = torch.zeros((B, ck - 1, cdim), dtype=u.dtype, device=u.device)
    ext = torch.cat([tail, u], dim=1)               # [B, S+ck-1, cdim]
    y = sum(ext[:, i:i + S, :] * w[i] for i in range(ck))
    y = F.silu(y + p["conv_b"].to(u.dtype))
    return y, ext[:, -(ck - 1):, :]


def mamba_block(p, x: torch.Tensor, cfg, *,
                cache: Optional[SSMCache] = None):
    """Full Mamba2 block.  x: [B,S,D].  Returns (y, new_cache); the new
    cache's state is in the cache's dtype."""
    B, S, D = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    z, xBC, dtr = _split_proj(p, x, cfg)
    xBC, new_tail = _causal_conv(p, xBC,
                                 cache.conv if cache is not None else None)
    xs = xBC[..., :di]
    Bm = xBC[..., di:di + cfg.ssm_groups * N]
    Cm = xBC[..., di + cfg.ssm_groups * N:]
    xh = xs.reshape(B, S, H, P)
    dt = softplus(dtr.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])

    if cache is None:
        y, _ = ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        new_cache = None
    elif S == 1:
        # recurrent decode step
        dA = torch.exp(dt[:, 0] * A[None, :])               # [B,H]
        st = cache.state * dA[..., None, None].to(cache.state.dtype)
        st = st + torch.einsum("bh,bhp,bn->bhpn", dt[:, 0].to(x.dtype),
                               xh[:, 0], Bm[:, 0])
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], st)[:, None]  # [B,1,H,P]
        new_cache = SSMCache(state=st, conv=new_tail)
    else:
        # chunked prefill with state carry-in
        y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                            init_state=cache.state)
        new_cache = SSMCache(state=final.to(cache.state.dtype),
                             conv=new_tail)

    y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), new_cache


def init_ssm_cache(cfg, batch: int, dtype, device) -> SSMCache:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return SSMCache(
        state=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)),
                         dtype=dtype, device=device))
