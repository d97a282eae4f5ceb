"""ctypes binding of the hand-written Hopper decode-attention kernels
(``csrc/decode_attention.cu``: a query token a row against one layer's
KV cache, in three passes over splits of :data:`SPLIT` keys), built at
first use by :mod:`repro_torch.kernels._build`.

The caches are read in place through their strides, at GQA size, over
each row's filled positions only; the filled end and the window's start
come from the device tensor ``positions``, so a launch takes no argument
that changes from one decode step to the next."""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "decode_attention.cu"
SPLIT = 128                  # keys a split (kSplit in the source)
MAX_GROUP = 8                # query heads a KV head (kMaxGroup)
MAX_HEAD_DIM = 128           # kMaxD
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def n_splits(S: int) -> int:
    """Splits of :data:`SPLIT` keys over a cache of ``S`` positions: the
    grid's first dimension."""
    return -(-S // SPLIT)


def scratch_layout(B: int, S: int, H: int, d: int) -> tuple:
    """Offsets, in floats, of the scratch's three parts in one f32
    buffer, each on 16 bytes, and the buffer's length: the scores
    ``[B * H, S]`` at 0, each split's (max, sum) ``[B * H, n_split, 2]``
    and the partial outputs ``[B * H, n_split, d]``."""
    def up(n):
        return -(-n // 4) * 4
    rows, ns = B * H, n_splits(S)
    stats = up(rows * S)
    partial = stats + up(rows * ns * 2)
    return stats, partial, partial + rows * ns * d


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.decode_attention_launch.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_split.argtypes = []
    lib.decode_attention_split.restype = ctypes.c_int
    if lib.decode_attention_split() != SPLIT:
        raise RuntimeError("decode_attention library and SPLIT disagree")
    return lib


def _check(q, k_cache, v_cache, pos, window) -> None:
    """Raise on what the kernel does not take: ``q [B, 1, H, d]``
    contiguous; ``k_cache``/``v_cache [B, S, K, d]`` of one shape and
    strides, the last dim contiguous, every row on 16 bytes; ``H`` a
    multiple of ``K`` by at most :data:`MAX_GROUP`; ``d`` at most 128
    and a multiple of 16 bytes; one dtype (f32 or bf16); ``positions``
    int32 with ``B`` elements; all on one CUDA device."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("positions", pos)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    if q.dim() != 4 or q.shape[1] != 1 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous [B, 1, H, d], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or not (q.dtype == k_cache.dtype
                                      == v_cache.dtype):
        raise ValueError("q and the caches must share one dtype, float32 "
                         "or bfloat16")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError("all inputs must be on one device")
    B, _, H, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or \
            k_cache.shape[0] != B or k_cache.shape[3] != d:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} / v_cache "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    K = k_cache.shape[2]
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"q heads {H} must be 1 to {MAX_GROUP} times the "
                         f"kv heads {K}")
    vec = 16 // q.element_size()
    if not 1 <= d <= MAX_HEAD_DIM or d % vec:
        raise ValueError(f"head dim {d}: the kernel takes d <= "
                         f"{MAX_HEAD_DIM}, rows a multiple of 16 bytes")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1 or \
            any(s % vec for s in k_cache.stride()[:3]) or \
            any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the caches must share strides, the last dim "
                         "contiguous, every row on 16 bytes")
    if pos.dtype != torch.int32 or pos.numel() != B or \
            not pos.is_contiguous():
        raise ValueError(f"positions must be contiguous int32 with {B} "
                         f"elements")
    if max(B, H) >= 65536 or k_cache.shape[1] >= 2**31 - SPLIT:
        raise ValueError("shape too large for the kernel's grid")
    if window < 0:
        raise ValueError(f"window {window} < 0")


@functools.cache
def _root(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) rounded to the dtype, as the plain version divides by it."""
    return float(torch.tensor(math.sqrt(d)).to(dtype))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, positions: torch.Tensor,
                            window: int = 0) -> torch.Tensor:
    """Launch the three passes on PyTorch's current stream: ``out [B, 1,
    H, d]`` in the q dtype, row b attending to the cache positions
    ``[lo, pos + 1)``, ``pos = positions[b]`` and ``lo`` the window's
    first position (0 without a window).  ``positions`` holds B int32
    (``[B]`` or ``[B, 1]``)."""
    pos = positions.reshape(-1)
    _check(q, k_cache, v_cache, pos, window)
    B, _, H, d = q.shape
    n = scratch_layout(B, k_cache.shape[1], H, d)[2]
    return _launch(q, k_cache, v_cache, pos, window,
                   torch.empty(n, dtype=torch.float32, device=q.device))


def _launch(q, k_cache, v_cache, pos, window, scratch) -> torch.Tensor:
    """The passes on checked inputs, into ``scratch`` (contiguous f32 of
    :func:`scratch_layout`'s length): a test reads what they leave
    there."""
    B, _, H, d = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    o_stats, o_partial, _ = scratch_layout(B, S, H, d)
    out = torch.empty_like(q)
    base = scratch.data_ptr()
    sb, ss, sh, _ = k_cache.stride()
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), base, base + 4 * o_stats,
            base + 4 * o_partial, _DTYPES[q.dtype], B, S, H, K, d, sb, ss,
            sh, int(window), _root(d, q.dtype), _stream(q))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{err}")
    return out
