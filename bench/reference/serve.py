"""The reference's reading of served tokens: one forward over each
prompt with its served tokens, in float32, and at each served position
how far the served token's logit lies below the best one.  The control
reads, at the same positions, the gap of the token its own lower
precision puts first."""
from __future__ import annotations

import torch

from .common import Prec, exact_f32, head_logits


@torch.no_grad()
def gaps(weights: dict, model_mod, m: dict, requests: list, *,
         control: Prec = None, rows: int = 8) -> dict:
    """``requests``: ``(prompt int [S], served int [n])`` on the device.
    Returns the widest gap of the served tokens (``served_gap``), of the
    control's first choices (``control_gap``, with ``control``), and how
    many tokens were read."""
    f32 = Prec("f32")
    with exact_f32():
        p = {n: t.float() for n, t in weights.items()}
        head = model_mod.head_matrix(p, m)
        by_len: dict = {}
        for prompt, served in requests:
            by_len.setdefault((prompt.shape[0], served.shape[0]), []).append(
                (prompt, served))
        widest, widest_ctl, n_tok = 0.0, 0.0, 0
        for (S, n), group in sorted(by_len.items()):
            for r0 in range(0, len(group), rows):
                blk = group[r0:r0 + rows]
                tok = torch.stack([torch.cat([pr, sv[:-1]]) for pr, sv in blk])
                served = torch.stack([sv for _, sv in blk]).long()
                h = model_mod.hidden(p, tok, m, f32)[:, S - 1:]
                logits = head_logits(h, head, f32)              # [b, n, V]
                best = logits.max(-1).values
                got = logits.gather(-1, served[..., None])[..., 0]
                widest = max(widest, float((best - got).max()))
                n_tok += served.numel()
                if control is not None:
                    hc = model_mod.hidden(p, tok, m, control)[:, S - 1:]
                    pick = head_logits(hc, head, control).argmax(-1)
                    cg = best - logits.gather(-1, pick[..., None])[..., 0]
                    widest_ctl = max(widest_ctl, float(cg.max()))
                del h, logits
    out = {"served_gap": widest, "tokens": n_tok}
    if control is not None:
        out["control_gap"] = widest_ctl
    return out
