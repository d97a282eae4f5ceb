"""Build and ctypes binding of the hand-written Hopper ``nvt_probe``
kernel (``csrc/nvt_probe.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/repro_torch_kernels/``
at the root of the checkout.  The library's name carries a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is compiled or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).parent / "csrc" / "nvt_probe.cu"
ROOT = Path(__file__).resolve().parents[4]          # the checkout
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
QUERIES_PER_BLOCK = 8      # kWarpsPerBlock in the source: one warp a query


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return found


def build():
    """Compile the kernel unless this source is already built.  Returns
    ``(library path, ptxas report)``; the report (registers, spills) is
    what ``nvcc -Xptxas -v`` printed for the build."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"nvt_probe_{tag}.so"
    report = so.with_suffix(".ptxas.txt")
    if so.exists() and report.exists():
        return so, report.read_text()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{r.stdout}{r.stderr}")
    tmp_report = report.with_name(f".{report.name}.{os.getpid()}")
    tmp_report.write_text(r.stdout + r.stderr)
    os.replace(tmp, so)
    os.replace(tmp_report, report)
    return so, report.read_text()


@functools.cache
def _library():
    so, _ = build()
    lib = ctypes.CDLL(str(so))
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
