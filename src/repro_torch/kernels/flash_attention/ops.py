"""User-facing flash attention in the model layout (port of
``repro.kernels.flash_attention.ops.flash_attention``), and its gradient.

A CUDA tensor launches the hand-written kernel ``kernel.py:fwd_route``
names, which reads the model layout itself: for bf16 the wgmma kernel
(d % 8 == 0 from 64 to 128, every arch's head dim) or the mma.sync one,
for f32 the scalar one.  Where q, k or v needs a gradient (training), the call goes
through :class:`FlashAttentionFn`: its forward launches the kernel with
each row's log-sum-exp and saves q, k, v, o and lse; its backward launches
the backward kernels through :func:`flash_attention_bwd`.  A CPU tensor
takes the plain version (``ref.attention_ref``) on the kernel layout
``[B*H, S, d]``, which autograd differentiates.  A meta tensor (the
dry-run's cells) computes nothing: it gets empty outputs of the kernel's
shapes and adds the kernel's :func:`work` to the recording tallies
(:mod:`repro_torch.kernels.work`).  There is no fallback from one to the
other.  The TPU version's ``impl``, ``interpret``, ``block_q``
and ``block_k`` have no counterpart: the Hopper kernel's tiles are fixed
and it masks ragged sequence ends itself.  On the CUDA path each call's
host work is a profiler range while a profiler runs
(``nvt.flash_attention``, ``nvt.FlashAttentionFn.forward``/``.backward``,
``nvt.flash_attention_bwd``; :func:`repro_torch.obs.spans.profiled`).
"""
from __future__ import annotations

from collections import Counter

import torch

from ...obs.spans import profiled
from .. import work as _work
from .kernel import flash_attention_bwd_kernel, flash_attention_kernel
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref


def _shape_key(q, k, causal, window) -> tuple:
    return (*q.shape[:2], k.shape[1], q.shape[2], *k.shape[2:], bool(causal),
            int(window))


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs one head of one sequence attends: all of them,
    or under the causal mask (Sq == Sk) each query's keys up to its own,
    the last ``window`` of them where a window is set."""
    if not causal:
        return Sq * Sk
    if not window or window >= Sq:
        return Sq * (Sq + 1) // 2
    return window * (window + 1) // 2 + (Sq - window) * window


def work(B: int, Sq: int, Sk: int, H: int, K: int, d: int, *,
         causal: bool, window: int = 0, itemsize: int = 2,
         backward: bool = False, with_lse: bool = False) -> dict:
    """The least work of the forward kernel, or of the backward pair, at
    q [B, Sq, H, d] and k/v [B, Sk, K, d] of ``itemsize``-byte elements:
    ``flops``, 2 d a visible (query, key) pair for each product (the
    forward's S and PV; the backward's S, dP, dV, dQ and dK), and
    ``bytes``, each input read once and each output written once (the
    forward reads q, k, v and writes o, and the f32 row log-sum-exp where
    ``with_lse``; the backward reads q, k, v, o, do and lse and writes dq,
    dk and dv)."""
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    n_q, n_kv, n_rows = B * Sq * H * d, B * Sk * K * d, B * H * Sq
    if backward:
        return {"flops": 5 * 2 * d * pairs,
                "bytes": (4 * n_q + 4 * n_kv) * itemsize + 4 * n_rows}
    return {"flops": 2 * 2 * d * pairs,
            "bytes": (2 * n_q + 2 * n_kv) * itemsize
            + (4 * n_rows if with_lse else 0)}


def _work_of(q, k, causal, window, **kw) -> dict:
    B, Sq, H, d = q.shape
    return work(B, Sq, k.shape[1], H, k.shape[2], d, causal=causal,
                window=window, itemsize=q.element_size(), **kw)


def _meta_forward(q, k, v, causal, window, with_lse: bool):
    """The forward kernel on meta tensors: (o, lse or None), empty, and
    its work added to the recording tallies."""
    _check_heads(q, k)
    w = _work_of(q, k, causal, window, with_lse=with_lse)
    _work.add("flash_attention", w["flops"], w["bytes"])
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    return torch.empty_like(q), lse


class FlashAttentionFn(torch.autograd.Function):
    """The kernels under autograd: ``apply(q, k, v, causal, window)`` on
    CUDA tensors (or meta ones: shapes and work only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "meta":
            o, lse = _meta_forward(q, k, v, causal, window, with_lse=True)
        else:
            with profiled("FlashAttentionFn.forward"):
                o, lse = flash_attention_kernel(q, k, v, causal=causal,
                                                window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        with profiled("FlashAttentionFn.backward"):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                             do.contiguous(),
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, dh]; k/v: [B, Sk, K, dh] (GQA).  Returns
    [B, Sq, H, dh] in the q dtype.  ``flash_attention.launches`` counts
    the forward kernel launches made through this wrapper (a recomputed
    forward under activation checkpointing counts again), and
    ``flash_attention.shapes`` the same launches by
    ``(B, Sq, Sk, H, K, dh, causal, window)``; a meta tensor launches
    nothing and counts nothing."""
    if q.device.type == "meta":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return _meta_forward(q, k, v, causal, window, with_lse=False)[0]
    if q.is_cuda:
        with profiled("flash_attention"):
            if torch.is_grad_enabled() and (
                    q.requires_grad or k.requires_grad or v.requires_grad):
                out = FlashAttentionFn.apply(q, k, v, causal, window)
            else:
                out = flash_attention_kernel(q, k, v, causal=causal,
                                             window=window)
            if out.numel():
                flash_attention.launches += 1
                flash_attention.shapes[_shape_key(q, k, causal,
                                                  window)] += 1
            return out
    if not (q.device.type == k.device.type == v.device.type == "cpu"):
        raise ValueError("q, k and v must be on one device (CUDA for the "
                         "kernel, CPU for the plain version)")
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The gradient of :func:`flash_attention` in the model layout:
    ``(dq, dk, dv)`` from the forward's ``o`` [B, Sq, H, dh] and ``lse``
    [B, H, Sq] and ``do`` (the gradient of o).  A CUDA tensor launches the
    backward kernels (``flash_bwd_dq``, then ``flash_bwd_dkdv``), a CPU
    one takes :func:`flash_attention_bwd_plain`.
    ``flash_attention_bwd.launches`` counts the calls that launched the
    pair, ``flash_attention_bwd.shapes`` the same by shape.  A meta tensor
    gets empty gradients and adds the pair's :func:`work`."""
    if q.device.type == "meta":
        _check_heads(q, k)
        w = _work_of(q, k, causal, window, backward=True)
        _work.add("flash_attention_bwd", w["flops"], w["bytes"])
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v))
    if q.is_cuda:
        with profiled("flash_attention_bwd"):
            grads = flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                               causal=causal, window=window)
        if q.numel() and k.numel():
            flash_attention_bwd.launches += 1
            flash_attention_bwd.shapes[_shape_key(q, k, causal,
                                                   window)] += 1
        return grads
    if {t.device.type for t in (q, k, v, o, lse, do)} != {"cpu"}:
        raise ValueError("all inputs must be on one device (CUDA for the "
                         "kernels, CPU for the plain version)")
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """[B, S, n, d] -> the kernel layout [B*n, S, d]."""
    B, S, n, d = t.shape
    return t.transpose(1, 2).reshape(B * n, S, d)


def _model(t: torch.Tensor, B: int) -> torch.Tensor:
    """[B*n, S, d] -> [B, S, n, d]."""
    Bn, S, d = t.shape
    return t.reshape(B, Bn // B, S, d).transpose(1, 2)


def _check_heads(q, k) -> None:
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} are not a multiple of kv "
                         f"heads {k.shape[2]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain version in the model layout, on any device: the
    kernel layout ``[B*H, S, d]`` through :func:`ref.attention_ref`."""
    _check_heads(q, k)
    out = attention_ref(_heads(q), _heads(k), _heads(v), causal=causal,
                        window=window)
    return _model(out, q.shape[0])


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """The forward's ``lse`` [B, H, Sq] in plain PyTorch
    (:func:`ref.attention_lse_ref`)."""
    _check_heads(q, k)
    B, Sq, H, _ = q.shape
    return attention_lse_ref(_heads(q), _heads(k), causal=causal,
                             window=window).reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0):
    """The backward in plain PyTorch, in the model layout
    (:func:`ref.attention_bwd_ref`): ``(dq, dk, dv)``."""
    _check_heads(q, k)
    B, Sq, H, _ = q.shape
    dq, dk, dv = attention_bwd_ref(
        _heads(q), _heads(k), _heads(v), _heads(o),
        lse.reshape(B * H, Sq), _heads(do), causal=causal, window=window)
    return _model(dq, B), _model(dk, B), _model(dv, B)


flash_attention.launches = 0
flash_attention.shapes = Counter()
flash_attention_bwd.launches = 0
flash_attention_bwd.shapes = Counter()
