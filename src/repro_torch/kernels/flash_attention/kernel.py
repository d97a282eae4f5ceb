"""ctypes binding of the hand-written Hopper flash-attention kernels
(``csrc/flash_attention.cu``: bf16 on the tensor cores, f32 scalar), built
at first use by :mod:`repro_torch.kernels._build`."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128           # kMaxD in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention library and MAX_HEAD_DIM "
                           "disagree")
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: the model layout
    ``q [B,Sq,H,d]``, ``k/v [B,Sk,K,d]`` with ``H % K == 0`` and
    ``d <= 128``, one dtype (f32 or bf16), contiguous, on one CUDA
    device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, heads, d], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    B, Sq, H, d = q.shape
    _, Sk, K, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {K}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if max(B * H, -(-Sq // 64)) >= 65536 or \
            max(B * Sq * H * d, B * Sk * K * d) >= 2**62:
        raise ValueError("shape too large for the kernel's grid")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream (the tensor-core
    kernel for bf16, the scalar one for f32): ``o [B,Sq,H,d]`` in the q
    dtype.  Layout and semantics as ``ops.flash_attention``."""
    _check_inputs(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, K, d, int(bool(causal)),
            int(window), 1.0 / (d ** 0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return out
