"""ctypes binding of the hand-written Hopper flash-attention kernels
(``csrc/flash_attention.cu``: bf16 on the tensor cores, f32 scalar; the
forward, optionally with each row's log-sum-exp, and the backward), built
at first use by :mod:`repro_torch.kernels._build`.  :func:`fwd_route` and
:func:`bwd_route` name the forward kernel and the backward pair a dtype
and head dim launch; the library holds the same rules, and loading it
checks that the two agree."""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128           # kMaxD in the source
SMEM_LIMIT = 232_448         # dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward's and the backward's routes, by the number the library
# gives each
ROUTES = ("scalar", "mma_sync", "wgmma")
WGMMA_TILE_COLS = (64, 128)  # tile widths of the wgmma kernels
WGMMA_STAGES = (3, 2)        # ring depths of the wgmma pair's dq and dkdv
WGMMA_FWD_STAGES = 4         # ring depth of the wgmma forward


def bwd_route(d: int, dtype: torch.dtype) -> str:
    """The backward pair a head dim and dtype launch: ``"wgmma"`` (bf16 at
    d % 8 == 0 and 64 <= d <= 128: wgmma fed by TMA rings,
    warp-specialised, on tiles :func:`wgmma_tile_cols` wide; the TMA reads
    rows of d * 2 bytes, a multiple of 16), ``"mma_sync"`` (bf16 at any
    other d <= 128) or ``"scalar"`` (f32).  The rule is the source's
    ``bwd_route``; raises on a d or dtype no kernel takes."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if dtype not in _DTYPES:
        raise ValueError(f"no backward kernel for {dtype}")
    if dtype == torch.float32:
        return "scalar"
    return "wgmma" if d % 8 == 0 and d >= 64 else "mma_sync"


def fwd_route(d: int, dtype: torch.dtype) -> str:
    """The forward kernel a head dim and dtype launch, by the backward's
    rule (:func:`bwd_route`): ``"wgmma"`` (``flash_fwd_wg``: bf16 at
    d % 8 == 0 and 64 <= d <= 128, wgmma fed by a TMA ring, on tiles
    :func:`wgmma_tile_cols` wide), ``"mma_sync"`` (``flash_fwd_tc``: bf16
    at any other d <= 128) or ``"scalar"`` (f32).  The rule is the
    source's ``fwd_route``; raises on a d or dtype no kernel takes."""
    return bwd_route(d, dtype)


def fwd_smem_bytes(d: int, dtype: torch.dtype, route: str = None) -> int:
    """Dynamic shared memory of the forward kernel on ``route`` (the
    rule's by default) at ``(d, dtype)`` (the source's ``smem_bytes``,
    ``tc_smem_bytes`` and ``wg_fwd_smem_bytes``)."""
    route = route or fwd_route(d, dtype)
    if route == "scalar":              # f32 tiles of d + 1 columns
        return 4 * ((64 + 2 * 64) * (d + 1) + 64 * 65)
    if route == "mma_sync":            # two stages of K and V, 64 rows
        dp = -(-d // 16) * 16
        pitch = dp if dp % 64 == 0 else dp + 8
        return 2 * 4 * 64 * pitch
    # 1024 B of alignment slack; Q of 128 rows and the ring's K and V
    # tiles, [64][tile width] bf16 each; 2 x stages + 1 8-byte mbarriers
    return 1024 + (2 + 2 * WGMMA_FWD_STAGES) * 64 * wgmma_tile_cols(d) * \
        2 + 8 * (2 * WGMMA_FWD_STAGES + 1)


def wgmma_tile_cols(d: int) -> int:
    """Columns of the wgmma pair's tiles at head dim d (the source's
    ``wg_tile_cols``): 64 at d = 64, 128 above it; the TMA fills the
    columns past d with zeros."""
    return 64 if d <= 64 else 128


def bwd_smem_bytes(d: int, dtype: torch.dtype) -> tuple:
    """Dynamic shared memory of the backward's two kernels, ``(dq,
    dkdv)``, on the route of ``(d, dtype)`` (the source's
    ``*_smem_bytes``)."""
    route = bwd_route(d, dtype)
    if route == "scalar":              # f32 tiles of d + 1 columns
        tiles = 4 * (2 * 64 + 2 * 64) * (d + 1)
        return (tiles + 4 * 64 * 65, tiles + 4 * (2 * 64 * 65 + 2 * 64))
    if route == "mma_sync":            # six [64][pitch] bf16 tiles, 4 rows
        dp = -(-d // 16) * 16
        pitch = dp if dp % 64 == 0 else dp + 8
        return (2 * 6 * 64 * pitch + 4 * 4 * 64,) * 2
    # 1024 B of alignment slack; 4 + 2 x stages [64][tile width] bf16
    # tiles (two of each operand a block owns, the ring of the pair it
    # walks); f32 rows (dq: D of 128 rows; dkdv: lse and D of each stage's
    # 64); 2 x stages + 1 8-byte mbarriers
    cols = wgmma_tile_cols(d)

    def ring(stages):
        return 1024 + (4 + 2 * stages) * 64 * cols * 2 + \
            8 * (2 * stages + 1)
    return (ring(WGMMA_STAGES[0]) + 4 * 128,
            ring(WGMMA_STAGES[1]) + 4 * 2 * WGMMA_STAGES[1] * 64)


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_bwd_route.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_bwd_route.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.flash_attention_fwd_route.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_fwd_route.restype = ctypes.c_int
    lib.flash_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_longlong
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention library and MAX_HEAD_DIM "
                           "disagree")
    for dtype, code in _DTYPES.items():
        for d in range(1, MAX_HEAD_DIM + 1):
            got = (ROUTES[lib.flash_attention_bwd_route(code, d)],
                   tuple(lib.flash_attention_bwd_smem_bytes(code, d, i)
                         for i in (0, 1)),
                   ROUTES[lib.flash_attention_fwd_route(code, d)],
                   lib.flash_attention_fwd_smem_bytes(code, d))
            if got != (bwd_route(d, dtype), bwd_smem_bytes(d, dtype),
                       fwd_route(d, dtype), fwd_smem_bytes(d, dtype)):
                raise RuntimeError(f"flash_attention library and "
                                   f"fwd/bwd_route or their smem_bytes "
                                   f"disagree at d = {d}, {dtype}: {got}")
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
    if max(B * H, -(-Sq // 64), -(-Sk // 64)) >= 65536 or \
            max(B * Sq * H * d, B * Sk * K * d) >= 2**62:
        raise ValueError("shape too large for the kernel's grid")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, with_lse: bool = False,
                           route: str = None):
    """Launch the forward kernel :func:`fwd_route` names on PyTorch's
    current stream (``route`` names another bf16 kernel that takes the
    shape: ``"mma_sync"`` times or tests ``flash_fwd_tc`` where the rule
    takes ``flash_fwd_wg``): ``o [B,Sq,H,d]`` in the q dtype, and with
    ``with_lse`` also ``lse`` f32 [B, H, Sq], each row's log-sum-exp of
    its scaled, masked scores (+inf where a row sees no key); ``o`` is the
    same bits either way.  Layout and semantics as
    ``ops.flash_attention``.  ``flash_attention_kernel.routes`` counts the
    launches by route."""
    _check_inputs(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rule = fwd_route(d, q.dtype)
    route = route or rule
    if route not in ROUTES or (route == "scalar") != (rule == "scalar") or \
            (route == "wgmma" and rule != "wgmma"):
        raise ValueError(f"no {route} forward for d = {d}, {q.dtype}")
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the wgmma forward reads q, k and v through TMA: "
                         "each must start on 16 bytes")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel():
        lib = _library()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                _DTYPES[q.dtype], B, Sq, Sk, H, K, d, int(bool(causal)),
                int(window), 1.0 / (d ** 0.5), ROUTES.index(route),
                _stream(q))
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: "
                               f"cudaError {err}")
        flash_attention_kernel.routes[route] += 1
    return (out, lse) if with_lse else out


flash_attention_kernel.routes = Counter()


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               parts: int = 3, scratch=None):
    """Launch the backward kernels on PyTorch's current stream,
    ``flash_bwd_dq`` then ``flash_bwd_dkdv``, the pair :func:`bwd_route`
    names (bf16: wgmma at d % 8 == 0 from 64 to 128, mma.sync at any
    other d; f32: scalar): ``(dq, dk, dv)`` in the layouts and dtype of
    q, k, v, from the forward's ``o`` and ``lse`` and ``dout`` (the
    gradient of o).  ``parts`` 1 or 2 launches only the first or the
    second kernel (to time one alone; the second reads the row sums D
    that the first wrote into ``scratch``, f32 [B, H, Sq], so it takes
    the ``scratch`` of an earlier call); the gradients the skipped kernel
    writes are then left unset."""
    _check_inputs(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, shaped and typed "
                             f"as q {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [{B}, {H}, {Sq}]")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if scratch is None else scratch
    if D.shape != (B, H, Sq) or D.dtype != torch.float32 or parts not in (
            1, 2, 3):
        raise ValueError("scratch must be f32 [B, H, Sq], parts 1, 2 or 3")
    if bwd_route(d, q.dtype) == "wgmma" and (
            d * q.element_size() % 16 or
            any(t.data_ptr() % 16 for t in (q, k, v, o, dout))):
        raise ValueError("the wgmma backward reads q, k, v, o and dout "
                         "through TMA: each must start on 16 bytes, its "
                         "rows a multiple of 16 bytes")
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), D.data_ptr(), _DTYPES[q.dtype], parts, B, Sq, Sk,
            H, K, d, int(bool(causal)), int(window), 1.0 / (d ** 0.5),
            _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {err}")
    return dq, dk, dv
