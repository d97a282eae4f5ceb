"""The reference's first training steps: the same weights and rows as the
program's, forward and backward in float32 (or the control's precision),
then AdamW with the configuration's hyperparameters, its moments in
float32 and each parameter rounded to the dtype it is stored in, as the
configuration states.

Returns what the comparison reads: each step's loss, each leaf's first
gradient as AdamW takes it (before its clipping), and each leaf's change
over the steps."""
from __future__ import annotations

import math

import torch

from .common import Prec, chunked_nll_sum, exact_f32


def adamw_step(leaves: dict, grads: dict, mu: dict, nu: dict, step: int,
               opt: dict, stored: dict) -> None:
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
    lr = opt["lr"] * min(1.0, (step + 1) / opt["warmup_steps"])
    c1 = 1.0 - opt["b1"] ** (step + 1)
    c2 = 1.0 - opt["b2"] ** (step + 1)
    with torch.no_grad():
        for n, p in leaves.items():
            g = grads[n] * scale
            mu[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
            nu[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
            upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + opt["eps"])
            p.sub_(lr * (upd + opt["weight_decay"] * p))
            p.copy_(p.to(stored[n]).float())


def run(weights: dict, model_mod, m: dict, batches: list, opt: dict,
        prec: Prec, rows: int, rows_kept: int = None) -> dict:
    """``len(batches)`` steps from ``weights`` (``{name: tensor}`` in their
    stored dtypes, left unchanged) on ``batches`` (int [B, S + 1] each).
    ``rows`` rows go through the model at a time.  ``rows_kept`` takes the
    loss over only the first rows of each batch (a planted fault: half of
    the batch left out)."""
    with exact_f32():
        stored = {n: t.dtype for n, t in weights.items()}
        leaves = {n: t.detach().float().clone().requires_grad_(True)
                  for n, t in weights.items()}
        mu = {n: torch.zeros_like(p) for n, p in leaves.items()}
        nu = {n: torch.zeros_like(p) for n, p in leaves.items()}
        losses, first = [], {}
        for step, batch in enumerate(batches):
            batch = batch[:rows_kept] if rows_kept else batch
            B, S = batch.shape[0], batch.shape[1] - 1
            total = torch.zeros((), device=batch.device)
            for r0 in range(0, B, rows):
                tok = batch[r0:r0 + rows]
                h = model_mod.hidden(leaves, tok[:, :-1], m, prec)
                nll = chunked_nll_sum(h, model_mod.head_matrix(leaves, m),
                                      tok[:, 1:].long(), prec) / (B * S)
                nll.backward()
                total += nll.detach()
                del h, nll
            losses.append(float(total))
            grads = {n: p.grad for n, p in leaves.items()}
            if step == 0:
                first = {n: float(g.norm()) for n, g in grads.items()}
            adamw_step(leaves, grads, mu, nu, step, opt, stored)
            for p in leaves.values():
                p.grad = None
        change = {n: float((p.detach() - weights[n].float()).norm())
                  for n, p in leaves.items()}
    return {"losses": losses, "first_grad": first, "change": change}
