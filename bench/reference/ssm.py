"""Plain reference of a Mamba2 language model (arXiv:2405.21060;
hf:state-spaces/mamba2-370m), in float32: each layer
``x + out_proj(RMSNorm(SSD(conv(xBC)) + D x) * silu(z))`` of
``in_proj(RMSNorm(x))``, the SSD computed by the paper's chunked
quadratic form (its minimal listing), one group of B/C shared by all
heads.

Parameters arrive in the layout the benchmark hands to both sides
(:func:`param_layout`): matrices as [in, out], RMSNorm weights as their
offset from 1, the conv as [width, channels], A as ``A_log`` (A =
-exp(A_log)), the embedding's rows padded to a multiple of 128 and tied
to the head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Prec, rms_norm
from .dense import padded_rows


def sizes(m: dict) -> tuple:
    di = m["ssm_expand"] * m["d_model"]
    N, G = m["ssm_state"], m["ssm_groups"]
    return di, N, G, di // m["ssm_head_dim"], di + 2 * G * N


def param_layout(m: dict) -> list:
    """``(name, shape, init)`` of every leaf.  ``("a_log",)``: log of
    A ~ U(1, 16); ``("dt_bias",)``: the inverse softplus of dt drawn
    log-uniform in [1e-3, 1e-1] (the Mamba2 initialisation); both float32,
    as is ``D``."""
    D = m["d_model"]
    di, N, G, H, cdim = sizes(m)
    out = [("embed", (padded_rows(m["vocab"]), D), ("normal", m["embed_std"])),
           ("final_norm", (D,), ("zeros",))]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln", (D,), ("zeros",)),
                (p + "in_proj", (D, di + cdim + H), ("normal", D ** -0.5)),
                (p + "conv_w", (m["ssm_conv"], cdim),
                 ("normal", m["ssm_conv"] ** -0.5)),
                (p + "conv_b", (cdim,), ("zeros",)),
                (p + "A_log", (H,), ("a_log",)),
                (p + "D", (H,), ("ones",)),
                (p + "dt_bias", (H,), ("dt_bias",)),
                (p + "out_norm", (di,), ("zeros",)),
                (p + "out_proj", (di, D), ("normal", di ** -0.5))]
    return out


F32_LEAVES = ("A_log", "D", "dt_bias")


def head_matrix(p: dict, m: dict) -> torch.Tensor:
    return p["embed"][:m["vocab"]]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: sum of x over (j, i] below the diagonal,
    0 on it, -inf above (the exponentials of the masked entries are
    exact zeros, and so are their gradients)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = torch.cumsum(x.masked_fill(~low, 0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int, prec: Prec) -> torch.Tensor:
    """y of the selective state space x [b, S, H, P], dt [b, S, H], A [H]
    (< 0), B/C [b, S, N], from a zero state."""
    b, S, H, P = x.shape
    pad = -S % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = x.shape[1] // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, H, P)
    Ad = (dt * A).reshape(b, c, chunk, H).permute(0, 3, 1, 2)   # b h c l
    Bc, Cc = Bm.reshape(b, c, chunk, -1), Cm.reshape(b, c, chunk, -1)
    Acum = torch.cumsum(Ad, dim=-1)
    L = torch.exp(segsum(Ad))                                     # b h c l s
    G = prec.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = prec.einsum("bhcls,bcshp->bclhp", G[:, None] * L, X)
    decay = torch.exp(Acum[..., -1:] - Acum)                      # b h c l
    states = prec.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(Acum[..., -1], (1, 0))))  # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + prec.einsum("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(Acum))
    return y.reshape(b, c * chunk, H, P)[:, :S]


def layer(p: dict, i: int, x: torch.Tensor, m: dict,
          prec: Prec) -> torch.Tensor:
    q = f"blocks.{i}."
    b, S, _ = x.shape
    di, N, G, H, cdim = sizes(m)
    P = m["ssm_head_dim"]
    u = prec.mm(rms_norm(x, p[q + "ln"], m["norm_eps"]), p[q + "in_proj"])
    z, xbc, dtr = u[..., :di], u[..., di:di + cdim], u[..., di + cdim:]
    w = p[q + "conv_w"]                                        # [width, cdim]
    xbc = F.conv1d(xbc.transpose(1, 2), w.t()[:, None, :], p[q + "conv_b"],
                   padding=w.shape[0] - 1, groups=cdim)[..., :S]
    xbc = F.silu(xbc.transpose(1, 2))
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dtr + p[q + "dt_bias"])
    A = -torch.exp(p[q + "A_log"])
    xh = xs.reshape(b, S, H, P)
    y = ssd(xh, dt, A, Bm, Cm, m["ref_chunk"], prec)
    y = (y + p[q + "D"][:, None] * xh).reshape(b, S, di)
    y = rms_norm(y * F.silu(z), p[q + "out_norm"], m["norm_eps"])
    return x + prec.mm(y, p[q + "out_proj"])


def hidden(p: dict, tokens: torch.Tensor, m: dict, prec: Prec) -> torch.Tensor:
    x = p["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(layer, p, i, x, m, prec, use_reentrant=False)
        else:
            x = layer(p, i, x, m, prec)
    return rms_norm(x, p["final_norm"], m["norm_eps"])
