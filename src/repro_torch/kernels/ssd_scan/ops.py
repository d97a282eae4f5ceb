"""User-facing SSD chunk scan in the model layout (port of
``repro.kernels.ssd_scan.ops.ssd_scan``).

A CUDA tensor launches a hand-written kernel (``kernel.py``): the
tensor-core kernel for bf16, the scalar one for f32.  A CPU tensor takes
the plain version, the model's chunked SSD (``ref.ssd_chunked``).  There
is no fallback from one to the other, and no gradient on the card: a
CUDA call whose inputs need one raises.  Unlike the TPU wrapper, which
returned y only, both return the final carried state as well, which
prefill with a cache needs; and the kernel reads x and the one group's
B/C rows in place, through their strides, instead of a copy per head.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_scan_kernel
from .ref import ssd_chunked


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (< 0); Bm/Cm
    [B,S,N] (one group, shared by all heads); init_state [B,H,P,N] or
    None (zeros).  Returns (y [B,S,H,P] in the xh dtype, final state
    [B,H,P,N]): f32 from the kernel, the carry dtype of
    :func:`ref.ssd_chunked` from the plain version.
    ``ssd_scan.launches`` counts the kernel launches made through this
    wrapper."""
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xh, dt, A, Bm, Cm, init_state)):
            # the kernel's output carries no gradient: fail rather than
            # train with the SSM's gradients silently dropped
            raise NotImplementedError(
                "ssd_scan has no backward kernel on the card yet "
                "(ROADMAP.md, Queue 1 item 8: training the SSM and hybrid "
                "families); run training of mamba2/zamba2 on the CPU")
        f32 = torch.float32
        y, final = ssd_scan_kernel(
            xh, dt.to(f32).contiguous(), A.to(f32).contiguous(), Bm, Cm,
            chunk=chunk,
            init_state=None if init_state is None
            else init_state.to(f32).contiguous())
        if xh.shape[0] * xh.shape[2]:
            ssd_scan.launches += 1
        return y, final
    devices = {t.device.type for t in (xh, dt, A, Bm, Cm)}
    if init_state is not None:
        devices.add(init_state.device.type)
    if devices != {"cpu"}:
        raise ValueError("all inputs must be on one device (CUDA for the "
                         "kernel, CPU for the plain version)")
    return ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state=init_state)


ssd_scan.launches = 0
