"""Pieces the plain references share: the precision they compute in, the
norm, and the loss.  Plain PyTorch; nothing of the program is imported
anywhere under ``bench/reference``."""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint


class Prec:
    """How a reference computes its products.  ``"f32"``: in float32 with
    TF32 off, the reference.  ``"fp8"``: each operand of every product
    rounded to float8 e4m3 under a per-tensor scale first (the control:
    the precision one step below the configuration's bfloat16)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the products see it; the gradient passes
        through the rounding unchanged."""
        if self.kind == "f32":
            return x
        with torch.no_grad():
            s = x.abs().amax().clamp(min=1e-30) / 448.0
            r = (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *(self.q(o) for o in ops))


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for the duration."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the weight handed over as its offset from 1."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def head_logits(h: torch.Tensor, head: torch.Tensor,
                prec: Prec) -> torch.Tensor:
    """Logits over the vocabulary: ``head`` is [vocab, D]."""
    return prec.mm(h, head.t())


def chunked_nll_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    prec: Prec, rows: int = 1024) -> torch.Tensor:
    """Sum over positions of -log p(label), the [*, vocab] logits made a
    block of positions at a time (and again in the backward), so that
    they never all live at once."""
    h2, y = h.reshape(-1, h.shape[-1]), labels.reshape(-1)

    def block(hb, yb):
        logits = head_logits(hb, head, prec)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, yb[:, None])[:, 0]).sum()
    total = h.new_zeros(())
    for i in range(0, h2.shape[0], rows):
        hb, yb = h2[i:i + rows], y[i:i + rows]
        total = total + (checkpoint(block, hb, yb, use_reentrant=False)
                         if torch.is_grad_enabled() else block(hb, yb))
    return total
