"""Plain PyTorch versions of the Mamba2 SSD scan.

* :func:`ssd_chunked` -- the chunked SSD of the model (port of
  ``repro.models.mamba2.ssd_chunked``), the plain version of the
  ``ssd_scan`` kernel: same layout, same result pair, and the reference's
  casts to the input dtype kept where it makes them.
* :func:`ssd_ref` -- the sequential recurrence, the definitionally correct
  form (port of ``repro.kernels.ssd_scan.ref.ssd_ref``), used by the tests
  and the card's checks only::

      s_t = exp(dA_t) * s_{t-1} + dt_t * B_t (x) x_t
      y_t = C_t . s_t
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _segsum_exp(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) for j <= i else 0.  cum: [..., Q]."""
    diff = cum[..., :, None] - cum[..., None, :]
    Q = cum.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=cum.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh: [B,S,H,P]; dt: [B,S,H] (post-softplus);
    A: [H] (negative); Bm/Cm: [B,S,N] (one group).  Returns
    (y [B,S,H,P], final_state [B,H,P,N]); the state is carried in the
    dtype of ``init_state`` (zeros in the xh dtype when it is None)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    C_ = Sp // Q

    f32 = torch.float32
    xh_ = xh.reshape(B, C_, Q, H, P)
    dt_ = dt.reshape(B, C_, Q, H).to(f32)
    Bm_ = Bm.reshape(B, C_, Q, N)
    Cm_ = Cm.reshape(B, C_, Q, N)

    dA = dt_ * A[None, None, None, :]               # [B,C,Q,H] (<= 0)
    cum = torch.cumsum(dA, dim=2)                   # inclusive
    # intra-chunk: masked attention-like term
    L = _segsum_exp(cum.movedim(-1, 2))             # [B,C,H,Q,Q]
    cb = _einsum("bcin,bcjn->bcij", Cm_.to(f32), Bm_.to(f32))
    scores = cb[:, :, None] * L * dt_.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = _einsum("bchij,bcjhp->bcihp", scores.to(xh.dtype), xh_)

    # chunk-local final states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # [B,C,Q,H]
    sloc = _einsum("bcqh,bcqn,bcqhp->bchpn",
                   (decay_to_end * dt_).to(xh.dtype), Bm_, xh_)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # [B,C,H]
    carry = (torch.zeros((B, H, P, N), dtype=xh.dtype, device=xh.device)
             if init_state is None else init_state)
    before = []
    for c in range(C_):
        before.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) \
            + sloc[:, c]
    before = torch.stack(before, dim=1)                          # [B,C,H,P,N]

    y_inter = (_einsum("bcqn,bchpn->bcqhp", Cm_, before)
               * torch.exp(cum)[..., None].to(xh.dtype))
    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    return y, carry


def ssd_ref(xh: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same layout as the TPU kernel: xh [BH,C,Q,P], dt/dA [BH,C,Q],
    Bm/Cm [BH,C,Q,N] -> (y [BH,C,Q,P] in the xh dtype, final state
    [BH,P,N] in f32), computed step by step in f32 from ``init_state``
    (zeros when None).  The reference returns y only; the final state is
    kept here so the kernel's can be checked against it."""
    BH, C, Q, P = xh.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x = xh.reshape(BH, C * Q, P).to(f32)
    dt_ = dt.reshape(BH, C * Q).to(f32)
    dA_ = dA.reshape(BH, C * Q).to(f32)
    B_ = Bm.reshape(BH, C * Q, N).to(f32)
    C_ = Cm.reshape(BH, C * Q, N).to(f32)
    s = (torch.zeros((BH, P, N), dtype=f32, device=xh.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(C * Q):
        s = torch.exp(dA_[:, t])[:, None, None] * s + \
            dt_[:, t, None, None] * (x[:, t, :, None] * B_[:, t, None, :])
        ys.append(torch.einsum("bn,bpn->bp", C_[:, t], s))
    y = torch.stack(ys, dim=1).reshape(BH, C, Q, P)
    return y.to(xh.dtype), s
