"""User-facing SSD chunk scan in the model layout (port of
``repro.kernels.ssd_scan.ops.ssd_scan``), and its gradient.

A CUDA tensor launches the hand-written kernels ``kernel.py:fwd_route``
names: for bf16 the three chunk-parallel wgmma passes (every SSM arch's
shape) or the mma.sync kernel, for f32 the scalar one.  Where an input needs
a gradient (training), the call goes through :class:`SsdScanFn`: its
forward launches the kernel with each chunk's start state, its backward
launches the backward kernels through :func:`ssd_scan_bwd`.  A CPU tensor
takes the plain version, the model's chunked SSD (``ref.ssd_chunked``),
which autograd differentiates.  A meta tensor (the dry-run's cells)
computes nothing: it gets empty outputs of the kernel's shapes and dtypes
and adds the kernel's :func:`work` to the recording tallies
(:mod:`repro_torch.kernels.work`).  There is no fallback from one to the
other.  Unlike the TPU wrapper, which returned y only, both return the
final carried state as well, which prefill with a cache needs; and the
kernel reads x and the one group's B/C rows in place, through their
strides, instead of a copy per head.  On the CUDA path each call's host
work is a profiler range while a profiler runs (``nvt.ssd_scan``,
``nvt.SsdScanFn.forward``/``.backward``, ``nvt.ssd_scan_bwd``, and inside
them the casts (``.args``) and the kernels' ``.checks``, ``.alloc`` and
``.launch``;
:func:`repro_torch.obs.spans.profiled`).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from ...obs.spans import profiled
from .. import work as _work
from .kernel import ssd_scan_bwd_kernel, ssd_scan_kernel
from .ref import ssd_chunked, ssd_scan_bwd_plain


def work(B: int, S: int, H: int, P: int, N: int, chunk: int, *,
         itemsize: int = 2, backward: bool = False,
         with_states: bool = False, init_state: bool = False) -> dict:
    """The least work of the forward kernel, or of the backward, at xh
    [B, S, H, P] and B/C [B, S, N] of ``itemsize``-byte elements (dt, A,
    the states and ddt in f32): ``flops``, 2 a multiply-add of each chunk
    product it needs, and ``bytes``, each input read once and each output
    written once.

    Forward: C B^T on each chunk's lower triangle once per batch row (B/C
    are shared by the heads), and per head the triangular scores times x,
    C times the carried state and the state update; it reads x, dt, A, B,
    C (and ``init_state``) and writes y and the final state (and each
    chunk's start state, ``with_states``, as training does).  Backward:
    C B^T again; per head dy x^T and scores^T dy over P, dG B and dG^T C
    over N on the triangle, and dy S_prev, B dS^T, x dS and the carry's
    (dy o exp(cum))^T C in full; it reads x, dy, B, C, dt, A and the chunk
    states and writes dx, dB, dC and ddt (and dinit)."""
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        tri = q * (q + 1) // 2
        flops += B * 2 * N * tri
        flops += B * H * ((4 * P * tri + 4 * N * tri + 8 * q * P * N)
                          if backward
                          else (2 * P * tri + 2 * q * N * P + 2 * q * P * N))
    n_x, n_bc, n_dt = B * S * H * P, B * S * N, B * S * H
    state = B * H * P * N * 4
    chunk_states = -(-S // chunk) * state
    if backward:
        nbytes = (3 * n_x + 4 * n_bc) * itemsize + 2 * n_dt * 4 + 2 * H * 4 \
            + chunk_states + (state if init_state else 0)
    else:
        nbytes = (2 * n_x + 2 * n_bc) * itemsize + n_dt * 4 + H * 4 + state \
            + (state if init_state else 0) \
            + (chunk_states if with_states else 0)
    return {"flops": flops, "bytes": nbytes}


def _meta_forward(xh, dt, A, Bm, Cm, chunk, init_state, with_states):
    """The forward kernel on meta tensors: (y, final, chunk states or
    None), empty, and its work added to the recording tallies."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    w = work(B, S, H, P, N, chunk, itemsize=xh.element_size(),
             with_states=with_states, init_state=init_state is not None)
    _work.add("ssd_scan", w["flops"], w["bytes"])
    f32 = torch.float32
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    final = torch.empty((B, H, P, N), dtype=f32, device=xh.device)
    states = torch.empty((B, -(-S // chunk), H, P, N), dtype=f32,
                         device=xh.device) if with_states else None
    return y, final, states


class SsdScanFn(torch.autograd.Function):
    """``apply(xh, dt, A, Bm, Cm, init_state, chunk) -> (y, final)`` with
    its gradient.  On CUDA tensors (dt, A and init_state in f32) the
    forward launches the kernel, keeping each chunk's start state for the
    backward kernels; on CPU tensors the plain pieces stand in for both
    (``ref.ssd_chunked`` and :func:`ref.ssd_scan_bwd_plain`, in f64 for
    f64 inputs), which lets the wiring be checked on the host.  An unused
    output's cotangent and a None ``init_state`` are zeros, and a None
    ``init_state`` gets no gradient."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, init_state, chunk):
        ctx.set_materialize_grads(False)
        if xh.device.type == "meta":
            y, final, states = _meta_forward(xh, dt, A, Bm, Cm, chunk,
                                             init_state, True)
        elif xh.is_cuda:
            with profiled("SsdScanFn.forward"):
                y, final, states = ssd_scan_kernel(
                    xh, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                    with_states=True)
        else:
            (y, final), states = ssd_chunked(
                xh, dt, A, Bm, Cm, chunk, init_state=init_state), None
        ctx.save_for_backward(xh, dt, A, Bm, Cm, init_state, states)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        with profiled("SsdScanFn.backward"):
            xh, dt, A, Bm, Cm, init_state, states = ctx.saved_tensors
            with profiled("SsdScanFn.backward.args"):
                if dy is None:
                    dy = torch.zeros_like(xh)
                if dfinal is not None and xh.device.type != "cpu":
                    dfinal = dfinal.to(torch.float32)
                dy = dy.to(xh.dtype).contiguous()
                if dfinal is not None:
                    dfinal = dfinal.contiguous()
            dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(
                xh, dt, A, Bm, Cm, dy, chunk=ctx.chunk,
                init_state=init_state, dfinal=dfinal, states=states)
            return (dx.to(xh.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                    dB.to(Bm.dtype), dC.to(Cm.dtype),
                    None if dinit is None else dinit.to(init_state.dtype),
                    None)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (< 0); Bm/Cm
    [B,S,N] (one group, shared by all heads); init_state [B,H,P,N] or
    None (zeros).  Returns (y [B,S,H,P] in the xh dtype, final state
    [B,H,P,N]): f32 from the kernel, the carry dtype of
    :func:`ref.ssd_chunked` from the plain version.
    ``ssd_scan.launches`` counts the forward kernel launches made through
    this wrapper (a recomputed forward under activation checkpointing
    counts again), ``ssd_scan.shapes`` the same by ``(B, S, H, P, N,
    chunk)``; a meta tensor launches nothing and counts nothing."""
    if xh.device.type == "meta":
        f32 = torch.float32
        args = (xh, dt.to(f32), A.to(f32), Bm, Cm,
                None if init_state is None else init_state.to(f32))
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in args):
            return SsdScanFn.apply(*args, chunk)
        return _meta_forward(*args[:5], chunk, args[5], False)[:2]
    if xh.is_cuda:
        with profiled("ssd_scan"):
            f32 = torch.float32
            with profiled("ssd_scan.args"):
                args = (xh, dt.to(f32).contiguous(), A.to(f32).contiguous(),
                        Bm, Cm, None if init_state is None
                        else init_state.to(f32).contiguous())
            if torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in args):
                y, final = SsdScanFn.apply(*args, chunk)
            else:
                y, final = ssd_scan_kernel(*args[:5], chunk=chunk,
                                           init_state=args[5])
            if xh.shape[0] * xh.shape[2]:
                ssd_scan.launches += 1
                ssd_scan.shapes[_shape_key(xh, Bm, chunk)] += 1
            return y, final
    devices = {t.device.type for t in (xh, dt, A, Bm, Cm)}
    if init_state is not None:
        devices.add(init_state.device.type)
    if devices != {"cpu"}:
        raise ValueError("all inputs must be on one device (CUDA for the "
                         "kernel, CPU for the plain version)")
    return ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state=init_state)


def _shape_key(xh, Bm, chunk) -> tuple:
    return (*xh.shape, Bm.shape[-1], chunk)


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, init_state: Optional[torch.Tensor] = None,
                 dfinal: Optional[torch.Tensor] = None,
                 states: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_scan`: ``(dx, ddt, dA, dB, dC, dinit)``
    from the cotangents ``dy`` and ``dfinal`` (None for zeros); ``dinit``
    is None when ``init_state`` is.  A CUDA tensor launches the backward
    kernels, which read the forward's chunk start ``states``
    (``ssd_scan_kernel(..., with_states=True)``); a CPU one takes
    :func:`ref.ssd_scan_bwd_plain`, which recomputes them.
    ``ssd_scan_bwd.launches`` counts the calls that launched the kernels,
    ``ssd_scan_bwd.shapes`` the same by ``(B, S, H, P, N, chunk)``.  A
    meta tensor gets empty gradients (the kernels' dtypes) and adds the
    backward's :func:`work`."""
    if xh.device.type == "meta":
        B, S, H, P = xh.shape
        N = Bm.shape[-1]
        w = work(B, S, H, P, N, chunk, itemsize=xh.element_size(),
                 backward=True, init_state=init_state is not None)
        _work.add("ssd_scan_bwd", w["flops"], w["bytes"])
        f32 = torch.float32
        e = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        return (e((B, S, H, P), xh.dtype), e((B, S, H), f32), e((H,), f32),
                e((B, S, N), xh.dtype), e((B, S, N), xh.dtype),
                None if init_state is None else e((B, H, P, N), f32))
    if xh.is_cuda:
        if states is None:
            raise ValueError("the backward kernels read the forward's chunk "
                             "start states (with_states=True)")
        with profiled("ssd_scan_bwd"):
            grads = ssd_scan_bwd_kernel(xh, dt, A, Bm, Cm, dy, states,
                                        chunk=chunk, dfinal=dfinal,
                                        want_dinit=init_state is not None)
        if xh.shape[0] * xh.shape[1] * xh.shape[2]:
            ssd_scan_bwd.launches += 1
            ssd_scan_bwd.shapes[_shape_key(xh, Bm, chunk)] += 1
        return grads
    devices = {t.device.type for t in (xh, dt, A, Bm, Cm, dy)}
    for t in (init_state, dfinal):
        if t is not None:
            devices.add(t.device.type)
    if devices != {"cpu"}:
        raise ValueError("all inputs must be on one device (CUDA for the "
                         "kernels, CPU for the plain version)")
    return ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, dy, chunk=chunk,
                              init_state=init_state, dfinal=dfinal)


ssd_scan.launches = 0
ssd_scan.shapes = Counter()
ssd_scan_bwd.launches = 0
ssd_scan_bwd.shapes = Counter()
