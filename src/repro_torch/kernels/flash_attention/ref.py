"""Plain PyTorch attention: the oracle of the flash-attention kernels (port
of ``repro.kernels.flash_attention.ref.attention_ref``), with the row
log-sum-exp the forward kernel can emit and the backward the backward
kernels compute (the reference package has no backward kernel: its
training differentiates the jnp attention)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor):
    """f32 scores of q [BH, Sq, d] against k [BK, Sk, d] (GQA via
    BH % BK groups), divided by sqrt(d)."""
    group = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(group, dim=0).float()
    return torch.einsum("bqd,bkd->bqk", q.float(), k) / (q.shape[-1] ** 0.5)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, d]; k/v: [BK, Sk, d]; GQA via BH % BK groups.  Scores,
    softmax and the weighted sum in f32; a row with no visible key gives
    0; the output is in the q dtype."""
    BH, Sq, d = q.shape
    BK, Sk, _ = k.shape
    group = BH // BK
    v = v.repeat_interleave(group, dim=0).float()
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(mask[None], _scores(q, k), NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v)
    out = torch.where(mask.any(dim=-1)[None, :, None], out, 0.0)
    return out.to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """[BH, Sq] f32: each row's log-sum-exp of its visible scaled scores,
    +inf for a row with no visible key (as the forward kernel writes it)."""
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask[None], _scores(q, k), -torch.inf)
    return torch.where(mask.any(dim=-1)[None], torch.logsumexp(s, dim=-1),
                       torch.inf)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: int = 0):
    """dq [BH, Sq, d], dk and dv [BK, Sk, d] (in the input dtypes) of
    ``o = attention_ref(q, k, v)`` given ``do``, from the forward's ``o``
    and ``lse`` [BH, Sq] step by step, in f32, as the backward kernels
    compute them: P = exp(S - lse) on the visible entries (0 elsewhere and
    on a row with no visible key, whose lse is +inf), dV = P^T dO,
    dP = dO V^T, D = rowsum(dO o O), dS = P o (dP - D), dQ = dS K / sqrt(d)
    and dK = dS^T Q / sqrt(d); dK and dV summed over each GQA group."""
    BH, Sq, d = q.shape
    BK, Sk, _ = k.shape
    group = BH // BK
    scale = 1.0 / (d ** 0.5)
    q32, o32, do32 = q.float(), o.float(), do.float()
    k32 = k.repeat_interleave(group, dim=0).float()
    v32 = v.repeat_interleave(group, dim=0).float()
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = torch.einsum("bqd,bkd->bqk", q32, k32) * scale
    p = torch.where(mask[None], torch.exp(s - lse[..., None].float()), 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    dp = torch.einsum("bqd,bkd->bqk", do32, v32)
    D = torch.sum(do32 * o32, dim=-1)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k32) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q32) * scale
    dk = dk.reshape(BK, group, Sk, d).sum(dim=1)
    dv = dv.reshape(BK, group, Sk, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
