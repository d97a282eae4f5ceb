"""ctypes binding of the hand-written Hopper ``nvt_probe`` kernel
(``csrc/nvt_probe.cu``), built at first use by
:mod:`repro_torch.kernels._build`."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).parent / "csrc" / "nvt_probe.cu"
QUERIES_PER_BLOCK = 8      # kWarpsPerBlock in the source: one warp a query


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    lib.nvt_probe_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.nvt_probe_launch.restype = ctypes.c_int
    lib.nvt_probe_warps_per_block.argtypes = []
    lib.nvt_probe_warps_per_block.restype = ctypes.c_int
    if lib.nvt_probe_warps_per_block() != QUERIES_PER_BLOCK:
        raise RuntimeError("nvt_probe library and QUERIES_PER_BLOCK "
                           "disagree")
    return lib


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nvt_probe_kernel(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
                     queries: torch.Tensor):
    """Launch the kernel on PyTorch's current stream: ``(found, vals)``,
    both int32 ``[Q]``.  ``Q`` must be a multiple of
    :data:`QUERIES_PER_BLOCK` (``ops.nvt_probe`` pads with -1)."""
    _check(keys_tile, "keys_tile", 2)
    _check(vals_tile, "vals_tile", 2)
    _check(queries, "queries", 1)
    if vals_tile.shape != keys_tile.shape:
        raise ValueError("keys_tile and vals_tile shapes differ")
    dev = keys_tile.device
    if vals_tile.device != dev or queries.device != dev:
        raise ValueError("tiles and queries must be on one device")
    nb, cap = keys_tile.shape
    nq = queries.shape[0]
    if not (0 < nb < 2**31 and 0 < cap < 2**31 and nq < 2**31):
        raise ValueError(f"unsupported sizes NB={nb} cap={cap} Q={nq}")
    if nq % QUERIES_PER_BLOCK:
        raise ValueError(f"Q={nq} is not a multiple of {QUERIES_PER_BLOCK}")
    found = torch.empty(nq, dtype=torch.int32, device=dev)
    vals = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return found, vals
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.nvt_probe_launch(
            keys_tile.data_ptr(), vals_tile.data_ptr(), queries.data_ptr(),
            found.data_ptr(), vals.data_ptr(), nb, cap, nq,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nvt_probe launch failed: cudaError {err}")
    return found, vals
