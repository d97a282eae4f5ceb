"""Plain-PyTorch models of where the bf16 tensor-core kernels round, held
against the f32 plain versions at the tolerances the card's checks use.

The bf16 paths of ``flash_attention`` and ``ssd_scan`` multiply bf16
operands with f32 accumulation (``wgmma`` m64nNk16 on the routes every
arch takes, ``mma.sync`` m16n8k16 on the others).  Besides the bf16
inputs and output, each rounds its intermediates at fixed points:

* attention: the probabilities P of each 64-key tile, rounded to bf16
  before ``P V`` (the running max, sum and accumulator stay f32), on both
  forward routes (``flash_fwd_wg``: 128 query rows a block, two
  warpgroups of 64; ``flash_fwd_tc``: 64 rows; the same 64-key tiles);
* the attention backward (the wgmma pair at d = 64 and 128): P and dS
  from f32 scores, the f32 ``lse`` and ``D``, each rounded to bf16 as
  the A operand of dV += P^T dO, dK += dS^T Q (128-key by 64-query tiles)
  and dQ += dS K (64-key tiles), the sums in f32 in the kernels' tile
  order;
* SSD: the chunk's ``scores``, the state-update operand (``x o w`` in
  the wgmma passes' state pass, ``B o w`` in ``ssd_scan_tc``: the same
  product x^T diag(w) B) and the carried state as the operand of
  ``C S^T``, each split into a bf16 high part plus a bf16 low part (two
  products); the state itself is carried in f32 (the wgmma passes scan
  S_c+1 = exp(cum_last) S_c + Delta_c in f32 between their products).
  One bf16 each is not enough: at the serve shape (B = 4, H = 112) the
  card measured 0.283 on y where the intra- and inter-chunk terms
  cancel, beyond 5e-2 abs + rel;
* the SSD backward (its wgmma passes): dy o exp(cum) in each chunk's
  own state gradient, S_prev and dS as the state scan writes them for
  the chunk pass, scores^T, and dG summed over a block's group of heads
  in f32 before it meets B and C, each split into a high and a low part;
  dB and dC summed over the group's heads in f32, then over the groups
  in order, and rounded to bf16 once.

The models below repeat those roundings at the kernels' tiles (64-key
tiles; chunks of 128 tokens) and show, on the CPU, that they stay inside
2e-2 (attention) and 5e-2 (SSD), abs + rel, of the f32 references, and
the backwards' within ``2e-2 * max|ref|`` (attention) and ``5e-2 *
max|ref|`` (SSD), the card's tolerances.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain)
from repro_torch.kernels.ssd_scan.ref import (_segsum_exp, ssd_chunked,
                                              ssd_ref, ssd_scan_bwd_plain)

BF16 = torch.bfloat16
F32 = torch.float32


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back (round to nearest even, as the kernels'
    ``__floats2bfloat162_rn``)."""
    return t.to(BF16).to(F32)


def _split(t: torch.Tensor) -> torch.Tensor:
    """What a bf16 high part plus the bf16 low part of the remainder
    carry (``tc::split_bf16``)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def attention_tc_model(q, k, v, *, causal=True, tile=64):
    """The bf16 kernel's arithmetic: q/k/v [B, S, H, d] bf16 (K == H),
    scores and the online softmax in f32 per 64-key tile, P rounded to
    bf16 before P V, output rounded to bf16."""
    B, S, H, d = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,d]
    scale = 1.0 / d ** 0.5
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, d))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        s = torch.where(vis, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", _bf16(p), vt)
        m = m_new
    out = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return out.transpose(1, 2).to(BF16)


def ssd_tc_model(xh, dt, A, Bm, Cm, chunk, init_state=None,
                 rnd=_split, route="wgmma"):
    """The bf16 kernels' arithmetic: xh [B,S,H,P] and Bm/Cm [B,S,N] bf16,
    dt [B,S,H] and A [H] f32.  Per chunk: G = C B^T in f32; scores =
    G o exp(cum_i - cum_j) o dt_j (j <= i) through ``rnd``; y = scores x
    + exp(cum_i) (C rnd(S)^T); S <- exp(cum_last) S + Delta, Delta =
    rnd(x o w)^T B (``route="wgmma"``: the state pass) or x^T rnd(B o w)
    (``"mma_sync"``: ``ssd_scan_tc``).  ``rnd`` is the kernels' hi/lo
    split; ``_bf16`` models one rounding.  Returns (y in bf16, final
    state in f32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    x, b, c = xh.float(), Bm.float(), Cm.float()
    st = torch.zeros((B, H, P, N)) if init_state is None \
        else init_state.float().clone()
    ys = []
    for t0 in range(0, S, chunk):
        xc = x[:, t0:t0 + chunk].transpose(1, 2)            # [B,H,Q,P]
        bc, cc = b[:, t0:t0 + chunk], c[:, t0:t0 + chunk]    # [B,Q,N]
        dtc = dt[:, t0:t0 + chunk].transpose(1, 2).float()   # [B,H,Q]
        cum = torch.cumsum(dtc * A[None, :, None], dim=-1)   # [B,H,Q]
        Q = cum.shape[-1]
        g = torch.einsum("bin,bjn->bij", cc, bc)[:, None]    # [B,1,Q,Q]
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
        decay = torch.exp(torch.where(
            tri, cum[..., :, None] - cum[..., None, :], -torch.inf))
        scores = rnd(g * decay * dtc[..., None, :])
        y = torch.einsum("bhij,bhjp->bhip", scores, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bhip", cc, rnd(st))
        w = torch.exp(cum[..., -1:] - cum) * dtc               # [B,H,Q]
        if route == "wgmma":
            delta = torch.einsum("bhjp,bjn->bhpn", rnd(xc * w[..., None]),
                                 bc)
        else:
            delta = torch.einsum("bhjp,bhjn->bhpn", xc,
                                 rnd(bc[:, None] * w[..., None]))
        st = torch.exp(cum[..., -1])[..., None, None] * st + delta
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1).to(BF16), st


def _close(got, want, tol):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        f"max abs error {float(err.max())} beyond {tol} abs + rel"


@pytest.mark.parametrize("S", [512, 500])
def test_attention_bf16_roundings_fit_the_tolerance(S):
    """At the serve head dim (d = 112), causal, B = 1, H = 4: the
    kernel's roundings against ``flash_attention_plain`` in f32 on the
    same bf16 values, 2e-2 abs + rel."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, S, 4, 112)),
                               dtype=F32).to(BF16) for _ in range(3))
    got = attention_tc_model(q, k, v)
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=True)
    _close(got, want, 2e-2)
    # the model does round: it is not the f32 result to the last bit
    assert not torch.equal(got, want.to(BF16))


def attention_bwd_tc_model(q, k, v, o, lse, do, *, causal=True, window=0):
    """The wgmma backward pair's arithmetic in f32 on bf16 values: q, o, do
    [B, Sq, H, d], k/v [B, Sk, K, d], lse [B, H, Sq] f32.  P = exp(S *
    scale - lse) (0 where masked), D = rowsum(dO o O) and dS = P o (dP -
    D) in f32; dq sums bf16(dS) K over 64-key tiles in order
    (``flash_bwd_dq``); dk and dv sum bf16(dS^T) Q and bf16(P^T) dO over
    the group's heads and, in each, its 64-query tiles in order
    (``flash_bwd_dkdv``, a block of 128 keys holding both sums).  Returns
    (dq, dk, dv) rounded to bf16 as the kernels write them."""
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / d ** 0.5
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))  # [B,H,S,d]
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (k, v))
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    pb, dsb = _bf16(p), _bf16(ds)
    dq = torch.zeros((B, H, Sq, d))
    for k0 in range(0, Sk, 64):
        dq += dsb[..., k0:k0 + 64] @ kf[:, :, k0:k0 + 64]
    # dk and dv: per kv head, the group's heads in turn, each head's query
    # tiles in turn
    dk = torch.zeros((B, K, Sk, d))
    dv = torch.zeros((B, K, Sk, d))
    for g in range(G):
        heads = torch.arange(K) * G + g
        for q0 in range(0, Sq, 64):
            t = slice(q0, q0 + 64)
            dv += pb[:, heads, t].transpose(-1, -2) @ dof[:, heads, t]
            dk += dsb[:, heads, t].transpose(-1, -2) @ qf[:, heads, t]
    return (_bf16(dq * scale).transpose(1, 2), _bf16(dk * scale)
            .transpose(1, 2), _bf16(dv).transpose(1, 2))


# (B, Sq, Sk, H, K, d, causal, window): GQA 2:1 at d = 128 causal (ragged
# query and key tiles), a window over a causal mask, and non-causal
# Sq != Sk at d = 64
BWD_ROUNDING_CASES = [(1, 200, 200, 4, 2, 128, True, 0),
                      (1, 384, 384, 4, 2, 128, True, 128),
                      (1, 136, 328, 4, 4, 64, False, 0),
                      (1, 200, 200, 4, 4, 112, True, 0)]


@pytest.mark.parametrize("case", BWD_ROUNDING_CASES,
                         ids=["causal_gqa_d128", "window", "noncausal_d64",
                              "causal_d112"])
def test_attention_bwd_bf16_roundings_fit_the_tolerance(case):
    """The wgmma backward's roundings against ``flash_attention_bwd_plain``
    in f32 on the same bf16 values (o rounded to bf16 as the forward
    kernel writes it, the plain lse): each gradient within ``2e-2 *
    max|ref|``, and not equal to the f32 result rounded once."""
    B, Sq, Sk, H, K, d, causal, window = case
    rng = np.random.default_rng(Sq + Sk + d)

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=F32).to(BF16).float()
    q, do = rnd(B, Sq, H, d), rnd(B, Sq, H, d)
    k, v = rnd(B, Sk, K, d), rnd(B, Sk, K, d)
    mask = dict(causal=causal, window=window)
    o = _bf16(flash_attention_plain(q, k, v, **mask))
    lse = flash_attention_lse_plain(q, k, **mask)
    got = attention_bwd_tc_model(q, k, v, o, lse, do, **mask)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        err = float((a - w).abs().max())
        assert scale > 0 and err <= 2e-2 * scale, (name, err, scale)
        assert not torch.equal(a, _bf16(w)), name


def _ssd_inputs(seed, B, S, H, P, N):
    """Model-like inputs (tests/test_kernels.py's distributions)."""
    rng = np.random.default_rng(seed)
    xh = torch.as_tensor(rng.standard_normal((B, S, H, P)), dtype=F32)
    dt = torch.as_tensor(np.log1p(np.exp(rng.standard_normal((B, S, H)))),
                         dtype=F32)
    A = torch.as_tensor(-np.exp(rng.standard_normal(H) * 0.3), dtype=F32)
    Bm = torch.as_tensor(rng.standard_normal((B, S, N)) * 0.5, dtype=F32)
    Cm = torch.as_tensor(rng.standard_normal((B, S, N)) * 0.5, dtype=F32)
    init = torch.as_tensor(rng.standard_normal((B, H, P, N)) * 0.5,
                           dtype=F32)
    return xh.to(BF16), dt, A, Bm.to(BF16), Cm.to(BF16), init


@pytest.mark.parametrize("S", [512, 500])
def test_ssd_bf16_roundings_fit_the_tolerance(S):
    """At the serve SSD shape (P = N = 64, chunk 128), B = 1, H = 4, with a
    carried-in f32 state: the kernel's roundings against ``ssd_chunked``
    in f32 on the same bf16 values and against the sequential ``ssd_ref``,
    y and final state at 5e-2 abs + rel."""
    B, H, P, N, Q = 1, 4, 64, 64, 128
    xh, dt, A, Bm, Cm, init = _ssd_inputs(S, B, S, H, P, N)
    y, final = ssd_tc_model(xh, dt, A, Bm, Cm, Q, init_state=init)
    cy, cfin = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), Q,
                           init_state=init)
    _close(y, cy, 5e-2)
    _close(final, cfin, 5e-2)
    # the sequential oracle on the kernel layout [B*H, chunks, Q, ...]
    pad = (-S) % Q
    C = (S + pad) // Q

    def lay(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.movedim(2, 1).reshape((B * H, C, Q) + t.shape[3:])
    dtk = lay(dt)
    bc = [t[:, :, None].expand(B, S, H, N) for t in (Bm, Cm)]
    ry, rstate = ssd_ref(lay(xh.float()), dtk, dtk * A.repeat(B)[:, None,
                                                                   None],
                         lay(bc[0].float()), lay(bc[1].float()),
                         init_state=init.reshape(B * H, P, N))
    ry = ry.reshape(B, H, C * Q, P).movedim(1, 2)[:, :S]
    _close(y, ry, 5e-2)
    _close(final, rstate.reshape(B, H, P, N), 5e-2)
    assert not torch.equal(final, cfin)
    # the split is what buys the margin: with one bf16 rounding each, y
    # uses several times more of the tolerance and the state a hundred
    # times more
    y1, final1 = ssd_tc_model(xh, dt, A, Bm, Cm, Q, init_state=init,
                              rnd=_bf16)

    def used(got, want, tol=5e-2):
        return float(((got.float() - want).abs()
                      / (tol + tol * want.abs())).max())
    assert 3 * used(y, cy) < used(y1, cy)
    assert 100 * used(final, cfin) < used(final1, cfin)


@pytest.mark.parametrize("S", [512, 500])
def test_ssd_mma_sync_bf16_roundings_fit_the_tolerance(S):
    """``ssd_scan_tc``'s split (B o w where the wgmma passes split x o w)
    at the serve SSD shape, B = 1, H = 4, with a carried-in f32 state: y
    and the final state within 5e-2 abs + rel of ``ssd_chunked`` in f32,
    and within a small part of the tolerance of the wgmma passes' model
    (the two splits round the same product)."""
    B, H, P, N, Q = 1, 4, 64, 64, 128
    xh, dt, A, Bm, Cm, init = _ssd_inputs(S + 7, B, S, H, P, N)
    y, final = ssd_tc_model(xh, dt, A, Bm, Cm, Q, init_state=init,
                            route="mma_sync")
    cy, cfin = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), Q,
                           init_state=init)
    _close(y, cy, 5e-2)
    _close(final, cfin, 5e-2)
    wy, wfin = ssd_tc_model(xh, dt, A, Bm, Cm, Q, init_state=init)
    _close(final, wfin, 1e-4)
    _close(y, wy, 1e-2)


def ssd_bwd_tc_model(xh, dt, A, Bm, Cm, dy, chunk, group, rnd=_split):
    """The bf16 SSD backward's arithmetic (its delta pass, state scan and
    chunk pass) in f32 on bf16 values, from zero init_state and d final:
    xh, dy [B,S,H,P] and Bm/Cm [B,S,N] bf16, dt [B,S,H] and A [H] f32;
    ``group`` heads a chunk-pass block (H % group == 0).  The rounding
    points, through ``rnd``: dy o exp(cum) (each chunk's own state
    gradient), S_prev and dS (the split tiles), scores^T (dx) and the
    group's sum of dG (dC and dB); dB and dC summed in f32 over the
    group's heads, then over the groups, and rounded to bf16 once, as dx.
    Returns (dx, ddt, dA, dB, dC)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-S) % Q

    def chunks(t):                       # [B,S,...] -> [B,C,Q,...] f32
        t = torch.nn.functional.pad(t.float(),
                                    (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((B, -1, Q) + t.shape[2:])
    x = chunks(xh).permute(0, 1, 3, 2, 4)                   # [B,C,H,Q,P]
    g = chunks(dy).permute(0, 1, 3, 2, 4)
    d = chunks(dt).permute(0, 1, 3, 2)                      # [B,C,H,Q]
    Bc, Cc = chunks(Bm), chunks(Cm)                         # [B,C,Q,N]
    nC, nG = x.shape[1], H // group
    cum = torch.cumsum(d * A.float()[:, None], dim=-1)
    L = _segsum_exp(cum)
    G = (Cc @ Bc.transpose(-1, -2))[:, :, None]             # f32, once
    e = torch.exp(cum)
    w = torch.exp(cum[..., -1:] - cum) * d
    decay = torch.exp(cum[..., -1])
    # the forward's chunk start states (in f32, as the forward writes them)
    sloc = torch.einsum("bchq,bcqn,bchqp->bchpn", w, Bc, x)
    s_ = torch.zeros((B, H, P, N))
    before = []
    for c in range(nC):
        before.append(s_)
        s_ = decay[:, c, :, None, None] * s_ + sloc[:, c]
    S_prev = torch.stack(before, dim=1)
    # delta pass and state scan
    inc = torch.einsum("bchqp,bcqn->bchpn", rnd(e[..., None] * g), Cc)
    dS_ = torch.zeros((B, H, P, N))
    after = [None] * nC
    for c in reversed(range(nC)):
        after[c] = dS_
        dS_ = decay[:, c, :, None, None] * dS_ + inc[:, c]
    dS = torch.stack(after, dim=1)
    sdot = (dS * S_prev).sum((-1, -2))                      # f32 in the scan
    Sr, dSr = rnd(S_prev), rnd(dS)
    # chunk pass, a head at a time within its group
    dsc = g @ x.transpose(-1, -2)
    dG = dsc * L * d[..., None, :]
    bds = torch.einsum("bcjn,bchpn->bchjp", Bc, dSr)
    dw = (x * bds).sum(-1)
    scores = G * L * d[..., None, :]
    dx = w[..., None] * bds + rnd(scores).transpose(-1, -2) @ g
    E = g @ Sr
    rowdE = e * (Cc[:, :, None] * E).sum(-1)
    u = dsc * G * L
    direct = u.sum(-2)
    dcum = (u * d[..., None, :]).sum(-1) + rowdE - direct * d - dw * w
    dcum[..., -1] += (dw * w).sum(-1) + decay * sdot

    def by_group(t):                     # [B,C,H,...] -> [B,C,nG,...]
        return t.reshape((B, nC, nG, group) + t.shape[3:]).sum(3)
    dGsum = rnd(by_group(dG))
    dC = (by_group(e[..., None] * E) + dGsum @ Bc[:, :, None]).sum(2)
    dB = (dGsum.transpose(-1, -2) @ Cc[:, :, None]
          + by_group(w[..., None] * (x @ dSr))).sum(2)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = A.float()[:, None] * ddA + direct + \
        dw * torch.exp(cum[..., -1:] - cum)
    dA = (d * ddA).sum((0, 1, 3))

    def tokens(t):
        return t.reshape((B, -1) + t.shape[3:])[:, :S]
    return (tokens(dx.permute(0, 1, 3, 2, 4)).to(BF16),
            tokens(ddt.permute(0, 1, 3, 2)), dA, tokens(dB).to(BF16),
            tokens(dC).to(BF16))


@pytest.mark.parametrize("N,S", [(128, 256), (64, 250)],
                         ids=["mamba2_state", "zamba2_state_ragged"])
def test_ssd_bwd_bf16_roundings_fit_the_tolerance(N, S):
    """The SSD backward's roundings (``ssd_bwd_tc_model``: 4 heads a
    group, two groups) against ``ssd_scan_bwd_plain`` in f32 on the same
    bf16 values, at mamba2-370m's and zamba2-7b's P, N and chunk (a ragged
    S at zamba2's): each gradient within ``5e-2 * max|ref|``, the card's
    tolerance, and not equal to the f32 result rounded once.  The bf16
    outputs (dx, dB, dC) use their share mostly in their own final
    rounding; the splits buy the f32 outputs' margin: with one bf16
    rounding at each point ddt uses over a hundred times more of it and
    dA over five times more."""
    B, H, P, Q = 1, 8, 64, 128
    xh, dt, A, Bm, Cm, _ = _ssd_inputs(N + S, B, S, H, P, N)
    rng = np.random.default_rng(N)
    dy = torch.as_tensor(rng.standard_normal((B, S, H, P)),
                         dtype=F32).to(BF16)
    got = ssd_bwd_tc_model(xh, dt, A, Bm, Cm, dy, Q, 4)
    want = ssd_scan_bwd_plain(xh.float(), dt, A, Bm.float(), Cm.float(),
                              dy.float(), chunk=Q)[:5]
    one = ssd_bwd_tc_model(xh, dt, A, Bm, Cm, dy, Q, 4, rnd=_bf16)

    def used(a, w):
        return float((a.float() - w).abs().max() / w.abs().max()) / 5e-2
    for name, a, w, a1 in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                              one):
        assert used(a, w) <= 1, (name, used(a, w))
        assert not torch.equal(a.float(), w.to(a.dtype).float()), name
    assert 100 * used(got[1], want[1]) < used(one[1], want[1])
    assert 5 * used(got[2], want[2]) < used(one[2], want[2])
