"""Plain reference of a dense decoder with grouped-query attention,
per-head query/key RMSNorm and rotary embeddings by halves (Qwen3,
arXiv:2505.09388; hf:Qwen/Qwen3-1.7B), in float32.

Parameters arrive in the layout the benchmark hands to both sides
(:func:`param_layout`): matrices as [in, out], RMSNorm weights as their
offset from 1, the embedding's rows padded to a multiple of 128 (only the
first ``vocab`` are read), the head tied to the embedding or not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Prec, rms_norm


def padded_rows(vocab: int) -> int:
    return -(-vocab // 128) * 128


def param_layout(m: dict) -> list:
    """``(name, shape, init)`` of every leaf; ``init`` is ``("normal",
    std)``, ``("zeros",)`` or ``("ones",)``, all in the parameter dtype."""
    D, H, K, dh, dff = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                        m["head_dim"], m["d_ff"])
    out = [("embed", (padded_rows(m["vocab"]), D), ("normal", m["embed_std"])),
           ("final_norm", (D,), ("zeros",))]
    if not m["tie_embeddings"]:
        out.append(("lm_head", (D, padded_rows(m["vocab"])),
                    ("normal", D ** -0.5)))
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1", (D,), ("zeros",)), (p + "ln2", (D,), ("zeros",)),
                (p + "attn.wq", (D, H * dh), ("normal", D ** -0.5)),
                (p + "attn.wk", (D, K * dh), ("normal", D ** -0.5)),
                (p + "attn.wv", (D, K * dh), ("normal", D ** -0.5)),
                (p + "attn.wo", (H * dh, D), ("normal", (H * dh) ** -0.5))]
        if m["qk_norm"]:
            out += [(p + "attn.q_norm", (dh,), ("zeros",)),
                    (p + "attn.k_norm", (dh,), ("zeros",))]
        out += [(p + "mlp.w_gate", (D, dff), ("normal", D ** -0.5)),
                (p + "mlp.w_up", (D, dff), ("normal", D ** -0.5)),
                (p + "mlp.w_down", (dff, D), ("normal", dff ** -0.5))]
    return out


def head_matrix(p: dict, m: dict) -> torch.Tensor:
    """The output head as [vocab, D]."""
    V = m["vocab"]
    return p["embed"][:V] if m["tie_embeddings"] else p["lm_head"][:, :V].t()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding by halves; x [B, S, n, dh], pos [S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos.double()[:, None] * freq[None]).float()
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Prec, q_block: int = 1024) -> torch.Tensor:
    """Causal attention, q [B, S, H, dh] against k/v [B, S, K, dh], a block
    of queries at a time."""
    B, S, H, dh = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    outs = []
    kpos = torch.arange(S, device=q.device)
    for q0 in range(0, S, q_block):
        qb = q[:, q0:q0 + q_block]
        s = prec.einsum("bqhd,bkhd->bhqk", qb, k) / math.sqrt(dh)
        qpos = torch.arange(q0, q0 + qb.shape[1], device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        w = torch.softmax(s, dim=-1)
        outs.append(prec.einsum("bhqk,bkhd->bqhd", w, v))
    return torch.cat(outs, dim=1)


def layer(p: dict, i: int, x: torch.Tensor, m: dict,
          prec: Prec) -> torch.Tensor:
    a = f"blocks.{i}.attn."
    B, S, D = x.shape
    H, K, dh, eps = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["norm_eps"]
    h = rms_norm(x, p[f"blocks.{i}.ln1"], eps)
    q = prec.mm(h, p[a + "wq"]).reshape(B, S, H, dh)
    k = prec.mm(h, p[a + "wk"]).reshape(B, S, K, dh)
    v = prec.mm(h, p[a + "wv"]).reshape(B, S, K, dh)
    if m["qk_norm"]:
        q = rms_norm(q, p[a + "q_norm"], eps)
        k = rms_norm(k, p[a + "k_norm"], eps)
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    o = attention(q, k, v, prec).reshape(B, S, H * dh)
    x = x + prec.mm(o, p[a + "wo"])
    h = rms_norm(x, p[f"blocks.{i}.ln2"], eps)
    f = f"blocks.{i}.mlp."
    g = F.silu(prec.mm(h, p[f + "w_gate"])) * prec.mm(h, p[f + "w_up"])
    return x + prec.mm(g, p[f + "w_down"])


def hidden(p: dict, tokens: torch.Tensor, m: dict, prec: Prec) -> torch.Tensor:
    """The final-normed hidden states [B, S, D] of ``tokens`` [B, S]; each
    layer recomputed in the backward when a gradient is taken."""
    x = p["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(layer, p, i, x, m, prec, use_reentrant=False)
        else:
            x = layer(p, i, x, m, prec)
    return rms_norm(x, p["final_norm"], m["norm_eps"])
