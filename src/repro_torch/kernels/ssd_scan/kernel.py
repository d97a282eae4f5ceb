"""ctypes binding of the hand-written Hopper SSD chunk-scan kernel
(``csrc/ssd_scan.cu``), built at first use by
:mod:`repro_torch.kernels._build`."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
SMEM_LIMIT = 232_448         # dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(Q: int, P: int, N: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the
    source)."""
    return 4 * (Q * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) + P * (N + 1)
                + 3 * Q)


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    if lib.ssd_scan_smem_bytes(128, 64, 64) != smem_bytes(128, 64, 64):
        raise RuntimeError("ssd_scan library and smem_bytes disagree")
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_scan_kernel(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on PyTorch's current stream.  xh [B,S,H,P] and
    Bm/Cm [B,S,N] in f32 or bf16 (one dtype); dt [B,S,H], A [H] and
    init_state [B,H,P,N] (None for zeros) in f32; all contiguous on one
    device.  Returns (y [B,S,H,P] in the xh dtype, final state
    [B,H,P,N] in f32)."""
    if not isinstance(xh, torch.Tensor) or xh.dim() != 4:
        raise ValueError("xh must be a [B, S, H, P] tensor")
    B, S, H, P = xh.shape
    if xh.dtype not in _DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    N = Bm.shape[-1] if isinstance(Bm, torch.Tensor) else -1
    _check(xh, "xh", (B, S, H, P), xh.dtype)
    _check(dt, "dt", (B, S, H), torch.float32)
    _check(A, "A", (H,), torch.float32)
    _check(Bm, "Bm", (B, S, N), xh.dtype)
    _check(Cm, "Cm", (B, S, N), xh.dtype)
    if init_state is not None:
        _check(init_state, "init_state", (B, H, P, N), torch.float32)
    if len({t.device for t in (xh, dt, A, Bm, Cm)}) != 1 or (
            init_state is not None and init_state.device != xh.device):
        raise ValueError("all inputs must be on one device")
    if not 1 <= chunk <= 1024 or min(P, N) < 1:
        raise ValueError(f"unsupported chunk {chunk} or P={P}, N={N}")
    if smem_bytes(chunk, P, N) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} with P={P}, N={N} needs "
                         f"{smem_bytes(chunk, P, N)} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    if B * H >= 2**31 or B * S * H * P >= 2**62:
        raise ValueError("shape too large for the kernel's grid")
    y = torch.empty_like(xh)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    if B * H == 0:
        return y, final
    lib = _library()
    with torch.cuda.device(xh.device):
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init_state is None else
            init_state.data_ptr(), y.data_ptr(), final.data_ptr(),
            _DTYPES[xh.dtype], B, S, H, P, N, chunk,
            torch.cuda.current_stream(xh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    return y, final
