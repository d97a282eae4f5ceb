"""Plain PyTorch attention: the oracle of the flash-attention kernel (port
of ``repro.kernels.flash_attention.ref.attention_ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, d]; k/v: [BK, Sk, d]; GQA via BH % BK groups.  Scores,
    softmax and the weighted sum in f32; a row with no visible key gives
    0; the output is in the q dtype."""
    BH, Sq, d = q.shape
    BK, Sk, _ = k.shape
    group = BH // BK
    k = k.repeat_interleave(group, dim=0).float()
    v = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), k) / (d ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v)
    out = torch.where(mask.any(dim=-1)[None, :, None], out, 0.0)
    return out.to(q.dtype)
