"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch (port
of ``repro.models.moe``).

Tokens are sorted by expert assignment and each expert runs one dense
``[capacity, D] @ [D, F]`` product (``torch.bmm`` over the experts, as
the reference leaves its einsums to XLA), so the work stays near the
active work times the capacity factor.  The two MoE variants:

  * qwen2-moe: 60 routed top-4 + 4 fused *shared* experts (always on);
  * arctic: 128 routed top-2 + a parallel *dense residual* FFN.

JAX semantics reproduced: ``lax.top_k`` takes the lower expert index on a
tie (a stable descending sort here), ``jnp.argsort`` is stable and
``searchsorted`` takes the left side.  A slot beyond an expert's capacity
is dropped: the reference scatters it to row ``E * cap`` and slices that
row away, here it is masked out.  The combine un-permutes the weighted
expert outputs into ``[T, K, D]`` and sums over K, a fixed order on every
device (a scatter-add with ``index_add_`` would be an unordered atomic sum
on CUDA).
"""
from __future__ import annotations

import torch

from .layers import dense_init, mlp, mlp_params


def _capacity(n_tokens: int, cfg) -> int:
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)   # round up to a multiple of 8


def route(p, xf: torch.Tensor, cfg):
    """Router of ``xf`` [T, D]: (probs [T, E] f32, renormalised top-k
    weights [T, K] f32, top-k experts [T, K] int64, lower index first on
    a tie)."""
    logits = xf @ p["router"].to(xf.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, cap: int, n_experts: int):
    """Sort the [T, K] slots by expert (stable): (order, the source token
    of each sorted slot, its row ``e * cap + position`` in the expert
    buffer, and ``keep``: whether that position is inside ``cap``)."""
    K = top_e.shape[1]
    flat_e = top_e.reshape(-1)                              # [T*K]
    order = torch.argsort(flat_e, stable=True)
    ranked_e = flat_e[order]
    seg_start = torch.searchsorted(
        ranked_e, torch.arange(n_experts, device=top_e.device), right=False)
    seg_pos = torch.arange(flat_e.numel(), device=top_e.device) - \
        seg_start[ranked_e]
    return order, order // K, ranked_e * cap + seg_pos, seg_pos < cap


def moe_ffn(p, x: torch.Tensor, cfg):
    """x: [B, S, D] -> (y [B, S, D], aux loss f32)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(T, D)

    probs, top_p, top_e = route(p, xf, cfg)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    # sort-based dispatch; a kept slot's row is unique
    cap = _capacity(T, cfg)
    order, tok_of, dest, keep = dispatch(top_e, cap, E)
    flat_w = top_p.reshape(-1).to(x.dtype)
    buf = torch.zeros((E * cap, D), dtype=x.dtype, device=x.device)
    buf[dest[keep]] = xf[tok_of[keep]]
    eb = buf.view(E, cap, D)

    # expert products
    ex = p["experts"]
    if "w_gate_up" in ex:
        g, u = torch.chunk(torch.bmm(eb, ex["w_gate_up"].to(x.dtype)), 2,
                           dim=-1)
        h = torch.nn.functional.silu(g) * u
    else:
        h = torch.nn.functional.silu(torch.bmm(eb, ex["w_gate"].to(
            x.dtype))) * torch.bmm(eb, ex["w_up"].to(x.dtype))
    ey = torch.bmm(h, ex["w_down"].to(x.dtype)).view(E * cap, D)

    # combine: each slot's weighted output back at (token, k), summed
    gathered = torch.where(keep[:, None],
                           ey[torch.clamp(dest, max=E * cap - 1)], 0.0)
    gathered = gathered * flat_w[order][:, None]
    slots = torch.empty_like(gathered)
    slots[order] = gathered
    y = slots.view(T, K, D).sum(dim=1).view(B, S, D)

    # always-on paths
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg.act)
    if "dense_res" in p:
        y = y + mlp(p["dense_res"], x, cfg.act)
    return y, aux.float()


def moe_params(gen: torch.Generator, cfg, dtype) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.fused_gate_up:
        experts = {"w_gate_up": dense_init(gen, (E, D, 2 * F), dtype,
                                           scale=D ** -0.5),
                   "w_down": dense_init(gen, (E, F, D), dtype,
                                        scale=F ** -0.5)}
    else:
        experts = {"w_gate": dense_init(gen, (E, D, F), dtype,
                                        scale=D ** -0.5),
                   "w_up": dense_init(gen, (E, D, F), dtype,
                                      scale=D ** -0.5),
                   "w_down": dense_init(gen, (E, F, D), dtype,
                                        scale=F ** -0.5)}
    p = {"router": dense_init(gen, (D, E), dtype), "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(gen, D, cfg.d_ff_shared, dtype, cfg.act,
                                 fused=cfg.fused_gate_up)
    if cfg.moe_dense_residual:
        p["dense_res"] = mlp_params(gen, D, cfg.d_ff_dense, dtype, cfg.act,
                                    fused=cfg.fused_gate_up)
    return p
