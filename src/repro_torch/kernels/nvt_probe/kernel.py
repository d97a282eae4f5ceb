"""ctypes binding of the hand-written Hopper ``nvt_probe`` kernel
(``csrc/nvt_probe.cu``), built at first use by
:mod:`repro_torch.kernels._build`.

The kernel takes any query count in one launch (it guards the ragged last
batch of 32 itself).  How a warp reads a row depends on ``cap`` and on
whether the tiles are 16-byte aligned; :func:`launch_geometry` computes
that here, where the host tests reach it, and the kernel checks it."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "nvt_probe.cu"
WARP = 32


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one warp reads its batch's rows: each row is ``cap // vec``
    loads of ``vec`` int32 words, spread over a group of ``lanes`` lanes
    (``WARP // lanes`` rows per load instruction) in ``chunks`` passes;
    lane ``t`` of the group loads vectors ``c * lanes + t`` for
    ``c < chunks`` that fall inside the row."""
    vec: int
    lanes: int
    chunks: int

    @property
    def rows_per_load(self) -> int:
        return WARP // self.lanes


def launch_geometry(cap: int, aligned: bool) -> Geometry:
    """16-byte vectors where the row allows them (``cap % 4 == 0`` and
    the keys tile 16-byte aligned), else single words; the fewest lanes (a
    power of two) that cover a row in one pass, at most as many as keep
    a pass within 32 words (one lane's 32-bit hit mask)."""
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    vec = 4 if aligned and cap % 4 == 0 else 1
    nvec = cap // vec
    lanes = min(WARP // vec, 1 << (nvec - 1).bit_length())
    return Geometry(vec, lanes, -(-nvec // lanes))


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.nvt_probe_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nvt_probe_launch.restype = ctypes.c_int
    return lib


def _check(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
           queries: torch.Tensor) -> None:
    """Raise on what the kernel does not take: int32, contiguous
    ``[NB, cap]`` tiles of one shape with ``NB, cap >= 1`` and int32
    ``[Q]`` queries, all on one CUDA device.  Shapes and types are
    checked before the device."""
    for name, t, ndim in (("keys_tile", keys_tile, 2),
                          ("vals_tile", vals_tile, 2),
                          ("queries", queries, 1)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have rank {ndim}, got {t.dim()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vals_tile.shape != keys_tile.shape:
        raise ValueError(f"keys_tile {tuple(keys_tile.shape)} and vals_tile "
                         f"{tuple(vals_tile.shape)} shapes differ")
    nb, cap = keys_tile.shape
    nq = queries.shape[0]
    if not (0 < nb < 2**31 and 0 < cap < 2**31 and nq < 2**31):
        raise ValueError(f"unsupported sizes NB={nb} cap={cap} Q={nq}")
    for name, t in (("keys_tile", keys_tile), ("vals_tile", vals_tile),
                    ("queries", queries)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    if not (keys_tile.device == vals_tile.device == queries.device):
        raise ValueError("tiles and queries must be on one device")


def nvt_probe_kernel(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
                     queries: torch.Tensor):
    """Launch the kernel once on PyTorch's current stream: ``(found,
    vals)``, both int32 ``[Q]``, for any ``Q`` (none for ``Q == 0``)."""
    _check(keys_tile, vals_tile, queries)
    dev = keys_tile.device
    nb, cap = keys_tile.shape
    nq = queries.shape[0]
    found = torch.empty(nq, dtype=torch.int32, device=dev)
    vals = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return found, vals
    g = launch_geometry(cap, keys_tile.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.nvt_probe_launch(
            keys_tile.data_ptr(), vals_tile.data_ptr(), queries.data_ptr(),
            found.data_ptr(), vals.data_ptr(), nb, cap, g.vec, g.lanes,
            g.chunks, nq,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nvt_probe launch failed: cudaError {err}")
    return found, vals
