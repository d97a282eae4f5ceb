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

* :func:`ssd_scan_passes_plain` -- the forward as the bf16 kernels split
  it into three passes: every chunk's own end-state contribution at
  once, then the scan over the chunks, then each chunk's output from the
  state it starts from.
* :func:`ssd_scan_bwd_plain` -- the gradient of :func:`ssd_chunked`,
  chunk by chunk, the plain version of the backward kernels (the
  reference has none: it differentiates its jnp ``ssd_chunked``).
* :func:`ssd_bwd_states_plain` -- the state gradients of that backward
  as the bf16 kernels split them: every chunk's own part at once (the
  delta pass), then the reverse scan over the chunks (the state scan).

All compute in f32, or in f64 where the inputs are f64.
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
    """exp(cum_i - cum_j) for j <= i else 0.  cum: [..., Q].  The
    reference takes ``where(mask, exp(diff), 0)``; here the mask goes in
    before the exponential, which gives the same values but keeps the
    gradient finite where exp(diff) above the diagonal overflows (cum
    falls by more than 88 in a chunk: 0 * inf would be NaN)."""
    diff = cum[..., :, None] - cum[..., None, :]
    Q = cum.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=cum.device))
    return torch.exp(torch.where(mask, diff, -torch.inf))


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

    f32 = torch.promote_types(torch.float32, xh.dtype)
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
    [BH,P,N] in f32, f64 for f64 inputs), computed step by step from
    ``init_state`` (zeros when None).  The reference returns y only; the final state is
    kept here so the kernel's can be checked against it."""
    BH, C, Q, P = xh.shape
    N = Bm.shape[-1]
    f32 = torch.promote_types(torch.float32, xh.dtype)
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


def _chunks(t: torch.Tensor, pad: int, Q: int, wd) -> torch.Tensor:
    """[B, S, ...] zero-padded by ``pad`` tokens and cut into chunks:
    [B, C, Q, ...] in ``wd``."""
    t = F.pad(t.to(wd), (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape((t.shape[0], -1, Q) + t.shape[2:])


def ssd_scan_passes_plain(xh: torch.Tensor, dt: torch.Tensor,
                          A: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor, chunk: int,
                          init_state: Optional[torch.Tensor] = None):
    """The chunked SSD computed as the bf16 forward kernels split it, in
    f32 (f64 for f64 inputs), same layout as :func:`ssd_chunked`.  With
    cum the inclusive cumsum of dt * A in each chunk and w_j =
    exp(cum_last - cum_j) dt_j:

      1. every chunk's own end-state contribution and decay, all chunks
         at once:  Delta_c = (x o w)^T B  [B, C, H, P, N],
         decay_c = exp(cum_last,c);
      2. the scan over the chunks: S_0 = init_state (zeros when None),
         S_c+1 = decay_c S_c + Delta_c;
      3. each chunk's output from the state it starts from:
         y_i = sum_j<=i (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
               + exp(cum_i) C_i S_c^T.

    Returns ``(y [B,S,H,P], final [B,H,P,N], states [B,C,H,P,N])``, the
    last each chunk's start state (what ``ssd_scan_kernel(...,
    with_states=True)`` writes)."""
    B, S, H, P = xh.shape
    Q = chunk
    pad = (-S) % Q
    wd = torch.promote_types(torch.float32, xh.dtype)
    x = _chunks(xh, pad, Q, wd).permute(0, 1, 3, 2, 4)     # [B,C,H,Q,P]
    d = _chunks(dt, pad, Q, wd).permute(0, 1, 3, 2)        # [B,C,H,Q]
    Bc, Cc = _chunks(Bm, pad, Q, wd), _chunks(Cm, pad, Q, wd)  # [B,C,Q,N]
    cum = torch.cumsum(d * A.to(wd)[:, None], dim=-1)
    w = torch.exp(cum[..., -1:] - cum) * d
    # 1. the chunks' own contributions and decays
    delta = torch.einsum("bchqp,bcqn->bchpn", x * w[..., None], Bc)
    decay = torch.exp(cum[..., -1])                        # [B,C,H]
    # 2. the scan
    s = torch.zeros(delta.shape[:1] + delta.shape[2:], dtype=wd,
                    device=xh.device) if init_state is None \
        else init_state.to(wd)
    before = []
    for c in range(delta.shape[1]):
        before.append(s)
        s = decay[:, c, :, None, None] * s + delta[:, c]
    states = torch.stack(before, dim=1)                    # [B,C,H,P,N]
    # 3. each chunk's output
    scores = (Cc @ Bc.transpose(-1, -2))[:, :, None] * _segsum_exp(cum) \
        * d[..., None, :]                                  # [B,C,H,Q,Q]
    y = scores @ x + torch.exp(cum)[..., None] * torch.einsum(
        "bcqn,bchpn->bchqp", Cc, states)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, -1, H, P)[:, :S]
    return y, s, states


def ssd_scan_bwd_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       dy: Optional[torch.Tensor], *, chunk: int,
                       init_state: Optional[torch.Tensor] = None,
                       dfinal: Optional[torch.Tensor] = None):
    """The gradient of the chunked SSD (:func:`ssd_chunked`'s ``(y,
    final)``) computed chunk by chunk, the algorithm the backward kernels
    run: ``(dx, ddt, dA, dB, dC, dinit)`` from the cotangents ``dy``
    [B,S,H,P] and ``dfinal`` [B,H,P,N] (None for zeros), in f32 (f64 for
    f64 inputs).  ``dinit`` is None when ``init_state`` is.

    Per chunk, with cum the inclusive cumsum of dt * A, L[i,j] =
    exp(cum_i - cum_j) for j <= i, G = C B^T, scores = G L dt_j,
    w_j = exp(cum_last - cum_j) dt_j, S_prev the state the chunk starts
    from and dS the gradient of the state it ends with:

      dscores = dy x^T                dG = dscores L dt_j
      dx = scores^T dy + w (B dS^T)   dC = dG B + exp(cum) (dy S_prev)
      dB = dG^T C + w (x dS)          dS_prev = exp(cum_last) dS
                                                + (dy exp(cum))^T C

    dS is carried from the last chunk back to the first (from dfinal; it
    ends as dinit).  ddt and dA come through d cum, reverse-cumsummed
    into d(dt * A); dB and dC are summed over the heads (one group shares
    B and C), dA over batch and time."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-S) % Q
    wd = torch.promote_types(torch.float32, xh.dtype)
    x = _chunks(xh, pad, Q, wd).permute(0, 1, 3, 2, 4)     # [B,C,H,Q,P]
    g = torch.zeros_like(x) if dy is None else \
        _chunks(dy, pad, Q, wd).permute(0, 1, 3, 2, 4)
    d = _chunks(dt, pad, Q, wd).permute(0, 1, 3, 2)        # [B,C,H,Q]
    Bc, Cc = _chunks(Bm, pad, Q, wd), _chunks(Cm, pad, Q, wd)  # [B,C,Q,N]
    a = A.to(wd)
    nC = x.shape[1]

    cum = torch.cumsum(d * a[:, None], dim=-1)             # [B,C,H,Q]
    L = _segsum_exp(cum)                                   # [B,C,H,Q,Q]
    G = (Cc @ Bc.transpose(-1, -2))[:, :, None]            # [B,C,1,Q,Q]
    scores = G * L * d[..., None, :]
    e = torch.exp(cum)
    w = torch.exp(cum[..., -1:] - cum) * d
    decay = torch.exp(cum[..., -1])                        # [B,C,H]

    # the state each chunk starts from (forward), and the gradient of the
    # state each chunk ends with (reverse)
    sloc = torch.einsum("bchq,bcqn,bchqp->bchpn", w, Bc, x)
    s = torch.zeros((B, H, P, N), dtype=wd, device=xh.device) \
        if init_state is None else init_state.to(wd)
    before = []
    for c in range(nC):
        before.append(s)
        s = decay[:, c, :, None, None] * s + sloc[:, c]
    S_prev = torch.stack(before, dim=1)                    # [B,C,H,P,N]
    inc = torch.einsum("bchq,bchqp,bcqn->bchpn", e, g, Cc)
    dS = torch.zeros((B, H, P, N), dtype=wd, device=xh.device) \
        if dfinal is None else dfinal.to(wd)
    after = [None] * nC
    for c in reversed(range(nC)):
        after[c] = dS
        dS = decay[:, c, :, None, None] * dS + inc[:, c]
    dS_next = torch.stack(after, dim=1)                    # [B,C,H,P,N]

    dsc = g @ x.transpose(-1, -2)                          # [B,C,H,Q,Q]
    dG = dsc * L * d[..., None, :]
    bds = torch.einsum("bcjn,bchpn->bchjp", Bc, dS_next)
    xds = x @ dS_next                                      # [B,C,H,Q,N]
    dx = scores.transpose(-1, -2) @ g + w[..., None] * bds
    E = e[..., None] * (g @ S_prev)                        # [B,C,H,Q,N]
    dC = (dG @ Bc[:, :, None] + E).sum(dim=2)              # [B,C,Q,N]
    dB = (dG.transpose(-1, -2) @ Cc[:, :, None]
          + w[..., None] * xds).sum(dim=2)
    dw = (Bc[:, :, None] * xds).sum(-1)                    # [B,C,H,Q]

    u = dsc * G * L              # d loss / d dt_j through scores, per i
    t = u * d[..., None, :]      # d loss / d L[i,j] * L[i,j]
    dcum = t.sum(-1) - t.sum(-2) + (Cc[:, :, None] * E).sum(-1) - dw * w
    dcum[..., -1] += (dw * w).sum(-1) + decay * (dS_next * S_prev).sum(
        (-1, -2))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = a[:, None] * ddA + u.sum(-2) + dw * torch.exp(cum[..., -1:] - cum)
    dA = (d * ddA).sum((0, 1, 3))

    def tokens(t):                       # [B,C,Q,...] -> [B,S,...]
        return t.reshape((B, -1) + t.shape[3:])[:, :S]
    return (tokens(dx.permute(0, 1, 3, 2, 4)),
            tokens(ddt.permute(0, 1, 3, 2)), dA, tokens(dB), tokens(dC),
            None if init_state is None else dS)


def ssd_bwd_states_plain(dt: torch.Tensor, A: torch.Tensor,
                         Cm: torch.Tensor, dy: torch.Tensor, *, chunk: int,
                         dfinal: Optional[torch.Tensor] = None):
    """The gradient of the state each chunk ends with, computed as the
    bf16 backward's delta pass and state scan compute it: first every
    chunk's own part at once,

      Delta_c = (dy_c o exp(cum_c))^T C_c          [B, C, H, P, N],

    then the reverse recurrence dS_c = exp(cum_last,c+1) dS_c+1 +
    Delta_c+1 from dS_last = dfinal (zeros when None).  Returns ``(delta,
    dS, dinit)``: dS [B, C, H, P, N] and dinit = exp(cum_last,0) dS_0 +
    Delta_0, the gradient of init_state; :func:`ssd_scan_bwd_plain`
    carries the same dS chunk by chunk.  In f32 (f64 for f64 inputs)."""
    B, S, H, P = dy.shape
    N = Cm.shape[-1]
    Q = chunk
    pad = (-S) % Q
    wd = torch.promote_types(torch.float32, dy.dtype)
    g = _chunks(dy, pad, Q, wd).permute(0, 1, 3, 2, 4)     # [B,C,H,Q,P]
    d = _chunks(dt, pad, Q, wd).permute(0, 1, 3, 2)        # [B,C,H,Q]
    Cc = _chunks(Cm, pad, Q, wd)                           # [B,C,Q,N]
    cum = torch.cumsum(d * A.to(wd)[:, None], dim=-1)
    delta = torch.einsum("bchq,bchqp,bcqn->bchpn", torch.exp(cum), g, Cc)
    decay = torch.exp(cum[..., -1])                        # [B,C,H]
    nC = delta.shape[1]
    s = torch.zeros((B, H, P, N), dtype=wd, device=dy.device) \
        if dfinal is None else dfinal.to(wd)
    dS = [None] * nC
    for c in reversed(range(nC)):
        dS[c] = s
        s = decay[:, c, :, None, None] * s + delta[:, c]
    return delta, torch.stack(dS, dim=1), s
