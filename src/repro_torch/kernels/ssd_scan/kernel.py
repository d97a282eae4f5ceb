"""ctypes binding of the hand-written Hopper SSD chunk-scan kernels
(``csrc/ssd_scan.cu``: the forward, bf16 on the tensor cores and f32
scalar, optionally with each chunk's start state; and its backward),
built at first use by :mod:`repro_torch.kernels._build`.
:func:`fwd_route` names the forward kernels a dtype and shape launch; the
library holds the same rule, and loading it checks that the two agree."""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import torch

from ...obs.spans import profiled
from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
SMEM_LIMIT = 232_448         # dynamic shared memory one block may use
TC_MAX_STATE = 128           # N the bf16 (tensor-core) kernel takes
TC_SLICE_P = 64              # P columns per block of the bf16 kernel
TC_BWD_MAX_P = 64            # P the bf16 backward's passes hold whole
TC_BWD_MAX_Q = 128           # chunk rows the bf16 backward's tiles hold
BWD_MAX_GROUP = 8            # heads a bf16 chunk-pass block sums over
BWD_WAVE = 132               # blocks of one wave on an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward's routes, by the number the library gives each
FWD_ROUTES = ("scalar", "mma_sync", "wgmma")


def fwd_route(P: int, N: int, chunk: int, dtype) -> str:
    """The forward kernels a shape and dtype launch: ``"wgmma"`` (bf16 at
    P <= 64, N <= 128 and chunks of up to 128 tokens, every SSM arch: the
    three chunk-parallel passes ``ssd_fwd_state_wg``,
    ``ssd_fwd_state_scan`` and ``ssd_fwd_chunk_wg``), ``"mma_sync"``
    (``ssd_scan_tc``: any other bf16 shape) or ``"scalar"`` (f32).  The
    rule is the source's ``fwd_route``."""
    if dtype not in _DTYPES:
        raise ValueError(f"no forward kernel for {dtype}")
    if dtype == torch.float32:
        return "scalar"
    return "wgmma" if P <= TC_BWD_MAX_P and N <= TC_MAX_STATE and \
        chunk <= TC_BWD_MAX_Q else "mma_sync"


def fwd_wg_smem_bytes(N: int) -> tuple:
    """Dynamic shared memory of the wgmma forward's state pass and chunk
    pass (the scan between them uses none): the state pass as the
    backward's delta pass (x and B as [128][64] bf16 boxes, four f32
    rows); the chunk pass 1024 bytes of alignment slack, B and C as
    [128][64] boxes (one or two each), two stages of a head's x and its
    split start state (:func:`fwd_split_state_bytes`), four f32 rows of
    128 and five 8-byte mbarriers."""
    nb = 1 if N <= 64 else 2
    return (delta_wg_smem_bytes(N),
            1024 + 2 * nb * 128 * 128 + 2 * (128 * 128 +
                                             fwd_split_state_bytes(N)) +
            4 * 4 * 128 + 8 * 5)


def fwd_split_state_bytes(N: int) -> int:
    """Bytes of one (batch, chunk, head)'s start state as the wgmma
    forward's scan writes it for its chunk pass
    (``ssd_scan_fwd_split_bytes`` in the source): a high and a low bf16
    part, [64][64] boxes, one or two of them a part."""
    return 2 * (1 if N <= 64 else 2) * 64 * 128


def fwd_smem_bytes(Q: int, P: int, N: int, dtype, route: str = None
                   ) -> int:
    """The largest dynamic shared memory a block of the forward uses on
    ``route`` (the rule's by default)."""
    route = route or fwd_route(P, N, Q, dtype)
    if route == "scalar":
        return f32_smem_bytes(Q, P, N)
    if route == "mma_sync":
        return tc_smem_bytes(Q, P, N)
    return max(fwd_wg_smem_bytes(N))


def smem_bytes(Q: int, P: int, N: int) -> int:
    """The f32 kernel's dynamic shared memory for a block of ``P``
    columns (``smem_bytes`` in the source)."""
    return 4 * (Q * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) + P * (N + 1)
                + 3 * Q)


def f32_slice_p(Q: int, P: int, N: int) -> int:
    """Columns of P a block of the f32 kernel owns (``f32_slice`` in the
    source): P, else P halved (rounded up) until the block fits
    ``SMEM_LIMIT``; 0 when not even one column fits."""
    w = P
    while w > 1 and smem_bytes(Q, w, N) > SMEM_LIMIT:
        w = (w + 1) // 2
    return w if smem_bytes(Q, w, N) <= SMEM_LIMIT else 0


def f32_smem_bytes(Q: int, P: int, N: int) -> int:
    """The f32 kernel's dynamic shared memory a block, its P split as
    :func:`f32_slice_p` splits it."""
    return smem_bytes(Q, max(1, f32_slice_p(Q, P, N)), N)


def tc_smem_bytes(Q: int, P: int, N: int) -> int:
    """The bf16 kernel's dynamic shared memory (``tc_layout`` in the
    source): two stages of the chunk's x slice and B in bf16 (widths
    padded to 16, rows of 64 or 128 swizzled, others padded by 8) and dt
    in f32, one C tile, the state's bf16 high and low parts, cum and four
    scan totals."""
    def r16(n):
        return -(-n // 16) * 16

    def pitch(w):
        return w if w % 64 == 0 else w + 8
    Qp, Np, XW = r16(Q), r16(N), min(TC_SLICE_P, r16(P))
    stage = 2 * Qp * (pitch(XW) + pitch(Np)) + 4 * Qp
    return 2 * stage + 2 * Qp * pitch(Np) + 4 * XW * pitch(Np) + \
        4 * (Qp + 4)


def carry_smem_bytes(Q: int, P: int, N: int) -> int:
    """The backward carry pass's dynamic shared memory for a block of
    ``P`` columns (``carry_smem_bytes`` in the source): one chunk's dy
    columns and C, the carried [P, N] gradient, dt, cum and exp(cum), all
    f32."""
    return 4 * (Q * (P + 1) + Q * (N + 1) + P * (N + 1) + 3 * Q)


def carry_slice_p(Q: int, P: int, N: int) -> int:
    """Columns of P a block of the carry pass owns (``carry_slice`` in the
    source), halved as :func:`f32_slice_p` halves them; 0 when not even
    one column fits."""
    w = P
    while w > 1 and carry_smem_bytes(Q, w, N) > SMEM_LIMIT:
        w = (w + 1) // 2
    return w if carry_smem_bytes(Q, w, N) <= SMEM_LIMIT else 0


def chunk_smem_bytes(Q: int) -> int:
    """The backward chunk pass's dynamic shared memory
    (``chunk_smem_bytes`` in the source): two [Q][Q + 1] f32 tiles, nine
    f32 rows of Q and eight warp sums."""
    return 4 * (2 * Q * (Q + 1) + 9 * Q + 8)


def delta_wg_smem_bytes(N: int) -> int:
    """The bf16 backward delta pass's dynamic shared memory
    (``delta_wg_smem_bytes`` in the source): 1024 bytes of alignment slack,
    the chunk's dy and C as [128][64] bf16 boxes (one for dy, one or two
    for C) and four f32 rows of 128."""
    nb = 1 if N <= 64 else 2
    return 1024 + (1 + nb) * 128 * 128 + 4 * 4 * 128


def chunk_wg_smem_bytes(N: int) -> int:
    """The bf16 backward chunk pass's dynamic shared memory (``cw_layout``
    in the source): alignment slack; B and C as [128][64] bf16 boxes (one
    or two each); G = C B^T's lower triangle as three [64][68] f32 tiles;
    stages of a head's x and dy and its S_prev and dS as the state scan
    split them (:func:`split_state_bytes`), two stages where N <= 64;
    twelve f32 rows of 128, one 64 x 64 tile's lower triangle of the
    group's dG sum in f32, four warp sums and six 8-byte mbarriers.  The
    phase after the head loop reuses G's and the stages' bytes."""
    nb = 1 if N <= 64 else 2
    stages = 2 if nb == 1 else 1
    return 1024 + 2 * nb * 128 * 128 + 3 * 64 * 68 * 4 + \
        stages * (2 * 128 * 128 + split_state_bytes(N)) + \
        4 * (12 * 128 + 64 * 65 // 2 + 4) + 8 * 6


def split_state_bytes(N: int) -> int:
    """Bytes of one (batch, chunk, head)'s S_prev and dS as the bf16
    backward's state scan writes them for its chunk pass
    (``ssd_scan_bwd_split_bytes`` in the source): a high and a low bf16
    part of each, [64][64] boxes, one or two of them a part."""
    return 4 * (1 if N <= 64 else 2) * 64 * 128


def bwd_heads_per_block(B: int, n_chunks: int, H: int) -> int:
    """Heads a block of the bf16 backward's chunk pass owns, summing dB
    and dC over them (``chunk_wg_group`` in the source), a divisor of H up
    to :data:`BWD_MAX_GROUP`: the largest where the (batch, chunk, head)
    triples make at most a wave of :data:`BWD_WAVE` blocks, else the one
    whose blocks (one an SM) fill their last wave best, the larger on a
    tie (mamba2-370m's training shape 8, zamba2-7b's 7: 512 blocks fill
    four waves where 8 heads' 448 leave the fourth 40% full)."""
    divs = [d for d in range(BWD_MAX_GROUP, 0, -1) if H % d == 0]
    if B * n_chunks * H <= BWD_WAVE:
        return divs[0]
    best, best_blocks, best_waves = 0, 0, 1
    for d in divs:
        blocks = B * n_chunks * (H // d)
        waves = -(-blocks // BWD_WAVE)
        if blocks * best_waves > best_blocks * waves:
            best, best_blocks, best_waves = d, blocks, waves
    return best


def bwd_smem_bytes(Q: int, P: int, N: int, dtype=torch.float32) -> tuple:
    """Dynamic shared memory a block of the backward's two tiled passes
    uses: for f32 ``(carry, chunk)``, the scalar passes, the carry pass's
    P split as :func:`carry_slice_p` splits it; for bf16 ``(delta,
    chunk)``, the wgmma passes (the state scan uses none)."""
    if dtype == torch.bfloat16:
        return delta_wg_smem_bytes(N), chunk_wg_smem_bytes(N)
    return (carry_smem_bytes(Q, max(1, carry_slice_p(Q, P, N)), N),
            chunk_smem_bytes(Q))


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 9 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_fwd_route.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_fwd_route.restype = ctypes.c_int
    lib.ssd_scan_fwd_wg_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.ssd_scan_fwd_wg_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_fwd_split_bytes.argtypes = [ctypes.c_int]
    lib.ssd_scan_fwd_split_bytes.restype = ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 22 + \
        [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_f32_slice.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_f32_slice.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_carry_slice.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_bwd_carry_slice.restype = ctypes.c_int
    lib.ssd_scan_bwd_group.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_bwd_group.restype = ctypes.c_int
    lib.ssd_scan_bwd_split_bytes.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_split_bytes.restype = ctypes.c_int
    for shape in ((128, 64, 64), (32, 16, 8), (100, 200, 72),
                  (128, 64, 128)):
        if (lib.ssd_scan_smem_bytes(*shape, 0),
                lib.ssd_scan_smem_bytes(*shape, 1),
                lib.ssd_scan_f32_slice(*shape),
                *(lib.ssd_scan_bwd_smem_bytes(*shape, d, k)
                  for d in (0, 1) for k in (0, 1)),
                lib.ssd_scan_bwd_carry_slice(*shape)) != (
                f32_smem_bytes(*shape), tc_smem_bytes(*shape),
                f32_slice_p(*shape), *bwd_smem_bytes(*shape),
                *bwd_smem_bytes(*shape, torch.bfloat16),
                carry_slice_p(*shape)):
            raise RuntimeError("ssd_scan library and smem_bytes disagree")
    for shape in ((2, 32, 32), (1, 32, 112), (2, 3, 4), (1, 1, 7),
                  (4, 8, 24)):
        if lib.ssd_scan_bwd_group(*shape) != bwd_heads_per_block(*shape):
            raise RuntimeError("ssd_scan library and bwd_heads_per_block "
                               "disagree")
    for N in (8, 64, 65, 128):
        if (lib.ssd_scan_bwd_split_bytes(N), lib.ssd_scan_fwd_split_bytes(N),
                *(lib.ssd_scan_fwd_wg_smem_bytes(N, k) for k in (0, 1))) != (
                split_state_bytes(N), fwd_split_state_bytes(N),
                *fwd_wg_smem_bytes(N)):
            raise RuntimeError("ssd_scan library and split_state_bytes / "
                               "fwd_wg_smem_bytes disagree")
    for dtype, code in _DTYPES.items():
        for P, N, Q in ((64, 128, 128), (64, 64, 128), (65, 64, 128),
                        (64, 129, 128), (64, 64, 129), (16, 8, 16)):
            if FWD_ROUTES[lib.ssd_scan_fwd_route(code, P, N, Q)] != \
                    fwd_route(P, N, Q, dtype):
                raise RuntimeError("ssd_scan library and fwd_route "
                                   "disagree")
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, dtype,
           contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def token_strides(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                  ) -> Tuple[int, ...]:
    """The batch and token strides (elements) of xh, Bm and Cm, which the
    kernel reads in place: ``(xsb, xst, bsb, bst, csb, cst)``.  Raises on
    a layout it does not take: xh's heads must lie ``P`` apart and its
    columns, like B's and C's, next to each other (the model's slices of
    its fused ``xBC`` activation do)."""
    _, _, H, P = xh.shape
    N = Bm.shape[-1]
    if (P > 1 and xh.stride(3) != 1) or (H > 1 and xh.stride(2) != P):
        raise ValueError(f"xh strides {xh.stride()}: heads must be {P} "
                         f"apart and columns adjacent")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if N > 1 and t.stride(2) != 1:
            raise ValueError(f"{name} strides {t.stride()}: columns must "
                             f"be adjacent")
    return (xh.stride(0), xh.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1))


def ssd_scan_kernel(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                    init_state: Optional[torch.Tensor] = None,
                    with_states: bool = False, route: str = None) -> tuple:
    """Launch the forward on PyTorch's current stream, on the route
    :func:`fwd_route` names (``route="mma_sync"`` names ``ssd_scan_tc``
    for a bf16 shape the rule gives the wgmma passes, to time or test
    it): for bf16 the three wgmma passes or the mma.sync kernel, for f32
    the scalar one.  xh [B,S,H,P] and Bm/Cm [B,S,N] in f32 or bf16 (one
    dtype), read through their batch and token strides
    (:func:`token_strides`); dt [B,S,H], A [H] and init_state [B,H,P,N]
    (None for zeros) in f32 and contiguous; all on one device.  Returns
    (y [B,S,H,P] in the xh dtype, final state [B,H,P,N] in f32), and with
    ``with_states`` the state each chunk starts from, [B, ceil(S / chunk),
    H, P, N] in f32, which the backward reads.
    ``ssd_scan_kernel.routes`` counts the launches by route."""
    with profiled("ssd_scan.checks"):
        B, S, H, P, N, strides, route = _fwd_checks(
            xh, dt, A, Bm, Cm, chunk, init_state, route)
    dev, f32 = xh.device, torch.float32
    n_chunks = -(-S // chunk)
    # the wgmma passes' scan runs in place over its chunk-state tensor, a
    # scratch one where the states are not asked for
    wg = route == "wgmma"
    with profiled("ssd_scan.alloc"):
        y = torch.empty((B, S, H, P), dtype=xh.dtype, device=dev)
        final = torch.empty((B, H, P, N), dtype=f32, device=dev)
        states = torch.empty((B, n_chunks, H, P, N), dtype=f32,
                             device=dev) if with_states or wg else None
        out = (y, final, states) if with_states else (y, final)
        if B * H == 0:
            return out
        split = torch.empty((B, n_chunks, H, fwd_split_state_bytes(N)),
                            dtype=torch.uint8, device=dev) if wg else None
        decay = torch.empty((B, n_chunks, H), dtype=f32, device=dev) \
            if wg else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    with profiled("ssd_scan.launch"), torch.cuda.device(dev):
        err = _library().ssd_scan_launch(
            *map(ptr, (xh, dt, A, Bm, Cm, init_state, y, final, states,
                       split, decay)),
            _DTYPES[xh.dtype], FWD_ROUTES.index(route), int(with_states),
            B, S, H, P, N, chunk, *strides,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    ssd_scan_kernel.routes[route] += 1
    return out


ssd_scan_kernel.routes = Counter()


def _fwd_checks(xh, dt, A, Bm, Cm, chunk, init_state, route):
    """The forward's arguments checked: (B, S, H, P, N, strides, route)."""
    if not isinstance(xh, torch.Tensor) or xh.dim() != 4:
        raise ValueError("xh must be a [B, S, H, P] tensor")
    B, S, H, P = xh.shape
    if xh.dtype not in _DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    N = Bm.shape[-1] if isinstance(Bm, torch.Tensor) else -1
    _check(xh, "xh", (B, S, H, P), xh.dtype, contiguous=False)
    _check(dt, "dt", (B, S, H), torch.float32)
    _check(A, "A", (H,), torch.float32)
    _check(Bm, "Bm", (B, S, N), xh.dtype, contiguous=False)
    _check(Cm, "Cm", (B, S, N), xh.dtype, contiguous=False)
    if init_state is not None:
        _check(init_state, "init_state", (B, H, P, N), torch.float32)
    if len({t.device for t in (xh, dt, A, Bm, Cm)}) != 1 or (
            init_state is not None and init_state.device != xh.device):
        raise ValueError("all inputs must be on one device")
    strides = token_strides(xh, Bm, Cm)
    if not 1 <= chunk <= 1024 or min(P, N) < 1:
        raise ValueError(f"unsupported chunk {chunk} or P={P}, N={N}")
    tc = xh.dtype == torch.bfloat16
    if tc and N > TC_MAX_STATE:
        raise ValueError(f"state size N={N} above {TC_MAX_STATE}, which "
                         f"the bf16 kernel holds in registers")
    rule = fwd_route(P, N, chunk, xh.dtype)
    route = route or rule
    if route not in FWD_ROUTES or (route == "scalar") != (not tc) or \
            (route == "wgmma" and rule != "wgmma"):
        raise ValueError(f"no {route} forward for P={P}, N={N}, chunk "
                         f"{chunk}, {xh.dtype}")
    need = fwd_smem_bytes(chunk, P, N, xh.dtype, route)
    if need > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} with P={P}, N={N} needs {need} "
                         f"bytes of shared memory, more than {SMEM_LIMIT}")
    if B * H * P >= 2**31 or B * S * H * P >= 2**62:
        raise ValueError("shape too large for the kernel's grid")
    return B, S, H, P, N, strides, route


def ssd_scan_bwd_kernel(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                        states: torch.Tensor, *, chunk: int,
                        dfinal: Optional[torch.Tensor] = None,
                        want_dinit: bool = False) -> tuple:
    """Launch the backward on PyTorch's current stream: for bf16 (P up to
    64, N up to 128, chunk up to 128) the wgmma delta pass, the state scan,
    the wgmma chunk pass over groups of :func:`bwd_heads_per_block` heads,
    the scan of each chunk's d cum and the reduction over the groups; for
    f32 the scalar carry pass, chunk pass and reduction over heads.  The forward's inputs as
    :func:`ssd_scan_kernel` takes them, ``states`` as it wrote them
    (``with_states``), dy [B,S,H,P] in the xh dtype and dfinal [B,H,P,N]
    in f32 (None for zeros), both contiguous.  Returns ``(dx, ddt, dA, dB,
    dC, dinit)``: dx, dB and dC in the xh dtype, the rest f32; dinit is
    None unless ``want_dinit``."""
    with profiled("ssd_scan_bwd.checks"):
        B, S, H, P, N, n_chunks, strides, bf16 = _bwd_checks(
            xh, dt, A, Bm, Cm, dy, states, chunk, dfinal)
    dev, f32 = xh.device, torch.float32
    with profiled("ssd_scan_bwd.alloc"):
        dx = torch.empty((B, S, H, P), dtype=xh.dtype, device=dev)
        ddt = torch.empty((B, S, H), dtype=f32, device=dev)
        dA = torch.zeros((H,), dtype=f32, device=dev)
        dB = torch.zeros((B, S, N), dtype=xh.dtype, device=dev)
        dC = torch.zeros((B, S, N), dtype=xh.dtype, device=dev)
        dinit = torch.empty((B, H, P, N), dtype=f32, device=dev) \
            if want_dinit else None
        if B * H * S == 0:
            if dinit is not None:
                dinit.copy_(torch.zeros_like(dinit) if dfinal is None
                            else dfinal)
            return dx, ddt, dA, dB, dC, dinit
        # scratch: each chunk's state gradient (bf16: first each chunk's
        # own part, Delta), the parts of dB and dC (f32: one a head; bf16:
        # one a group of heads), the (batch, chunk) parts of dA; for bf16
        # also each chunk's decay exp(cum_last), S_prev and dS split into
        # bf16 high and low parts, the state scan's parts of sum(S_prev o
        # dS), and the chunk pass's d cum of every row
        groups = H // bwd_heads_per_block(B, n_chunks, H) if bf16 else H
        dS_all = torch.empty_like(states)
        dB_g = torch.empty((B, S, groups, N), dtype=f32, device=dev)
        dC_g = torch.empty((B, S, groups, N), dtype=f32, device=dev)
        dA_part = torch.empty((B, n_chunks, H), dtype=f32, device=dev)
        decay = split = sdot = dcum = None
        if bf16:
            nb = 1 if N <= 64 else 2
            decay = torch.empty((B, n_chunks, H), dtype=f32, device=dev)
            split = torch.empty((B, n_chunks, H, split_state_bytes(N)),
                                dtype=torch.uint8, device=dev)
            sdot = torch.empty((B, n_chunks, H, 8 * nb), dtype=f32,
                               device=dev)
            dcum = torch.empty((B, S, H), dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with profiled("ssd_scan_bwd.launch"), torch.cuda.device(dev):
        err = _library().ssd_scan_bwd_launch(
            *map(ptr, (xh, dt, A, Bm, Cm, dy, dfinal, states, dS_all, dB_g,
                       dC_g, dA_part, decay, split, sdot, dcum, dx, ddt,
                       dA, dB, dC, dinit)),
            _DTYPES[xh.dtype], B, S, H, P, N, chunk, *strides,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: cudaError "
                           f"{err}")
    return dx, ddt, dA, dB, dC, dinit


def _bwd_checks(xh, dt, A, Bm, Cm, dy, states, chunk, dfinal):
    """The backward's arguments checked: (B, S, H, P, N, n_chunks,
    strides, bf16)."""
    if not isinstance(xh, torch.Tensor) or xh.dim() != 4:
        raise ValueError("xh must be a [B, S, H, P] tensor")
    B, S, H, P = xh.shape
    if xh.dtype not in _DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    N = Bm.shape[-1] if isinstance(Bm, torch.Tensor) else -1
    n_chunks = -(-S // chunk) if chunk >= 1 else 0
    _check(xh, "xh", (B, S, H, P), xh.dtype, contiguous=False)
    _check(dt, "dt", (B, S, H), torch.float32)
    _check(A, "A", (H,), torch.float32)
    _check(Bm, "Bm", (B, S, N), xh.dtype, contiguous=False)
    _check(Cm, "Cm", (B, S, N), xh.dtype, contiguous=False)
    _check(dy, "dy", (B, S, H, P), xh.dtype)
    _check(states, "states", (B, n_chunks, H, P, N), torch.float32)
    if dfinal is not None:
        _check(dfinal, "dfinal", (B, H, P, N), torch.float32)
    if len({t.device for t in (xh, dt, A, Bm, Cm, dy, states)}) != 1 or (
            dfinal is not None and dfinal.device != xh.device):
        raise ValueError("all inputs must be on one device")
    strides = token_strides(xh, Bm, Cm)
    if not 1 <= chunk <= 1024 or min(P, N) < 1:
        raise ValueError(f"unsupported chunk {chunk} or P={P}, N={N}")
    bf16 = xh.dtype == torch.bfloat16
    if bf16 and (P > TC_BWD_MAX_P or N > TC_MAX_STATE or
                 chunk > TC_BWD_MAX_Q):
        raise ValueError(f"P={P}, N={N}, chunk {chunk}: the bf16 backward "
                         f"holds P up to {TC_BWD_MAX_P}, N up to "
                         f"{TC_MAX_STATE} and chunks up to {TC_BWD_MAX_Q}")
    need = max(bwd_smem_bytes(chunk, P, N, xh.dtype))
    if need > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} with P={P}, N={N} needs {need} "
                         f"bytes of shared memory in the backward, more "
                         f"than {SMEM_LIMIT}")
    if B * H * P >= 2**31 or B * S * H * max(P, N) >= 2**62:
        raise ValueError("shape too large for the kernel's grid")
    return B, S, H, P, N, n_chunks, strides, bf16
