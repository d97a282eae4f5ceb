"""User-facing flash attention in the model layout (port of
``repro.kernels.flash_attention.ops.flash_attention``).

A CUDA tensor launches a hand-written kernel (``kernel.py``), which reads
the model layout itself: the tensor-core kernel for bf16, the scalar one
for f32.  A CPU tensor takes the plain version
(``ref.attention_ref``) on the kernel layout ``[B*H, S, d]``.  There is no
fallback from one to the other.  The TPU version's ``impl``,
``interpret``, ``block_q`` and ``block_k`` have no counterpart: the Hopper
kernel's tiles are fixed and it masks ragged sequence ends itself.
"""
from __future__ import annotations

from collections import Counter

import torch

from .kernel import flash_attention_kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, dh]; k/v: [B, Sk, K, dh] (GQA).  Returns
    [B, Sq, H, dh] in the q dtype.  ``flash_attention.launches`` counts
    the kernel launches made through this wrapper, and
    ``flash_attention.shapes`` the same launches by
    ``(B, Sq, Sk, H, K, dh, causal)``."""
    if q.is_cuda:
        out = flash_attention_kernel(q, k, v, causal=causal, window=window)
        if out.numel():
            flash_attention.launches += 1
            flash_attention.shapes[(*q.shape[:2], k.shape[1], q.shape[2],
                                    *k.shape[2:], bool(causal))] += 1
        return out
    if not (q.device.type == k.device.type == v.device.type == "cpu"):
        raise ValueError("q, k and v must be on one device (CUDA for the "
                         "kernel, CPU for the plain version)")
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain version in the model layout, on any device: the
    kernel layout ``[B*H, S, d]`` through :func:`ref.attention_ref`."""
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {K}")
    qh = q.transpose(1, 2).reshape(B * H, Sq, dh)
    kh = k.transpose(1, 2).reshape(B * K, Sk, dh)
    vh = v.transpose(1, 2).reshape(B * K, Sk, dh)
    out = attention_ref(qh, kh, vh, causal=causal, window=window)
    return out.reshape(B, H, Sq, dh).transpose(1, 2)


flash_attention.launches = 0
flash_attention.shapes = Counter()
