#!/usr/bin/env python3
"""Time the f32 ``ssd_scan`` kernel of this checkout in turns with the
same kernel built from another copy of its source (an earlier commit's),
on one card, at zamba2-7b's scan shape and at mamba2-370m's.

    git show <rev>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu \
        > build/chip_scripts/ssd_scan_base.cu
    python3 tools/ssd_f32_turns.py build/chip_scripts/ssd_scan_base.cu

Both sources are built by ``kernels/_build.py`` and called through their
C entry point ``ssd_scan_launch`` (with the arguments of the source's
own signature: 8 pointers before the chunk-state output, 9 with it, 11
and two more ints with the forward's route and scratch) on the
same buffers: B = 4, S = 512, chunk 128, a zero f32 initial state, as a
prefill into a cache passes it.  Base and this checkout's kernel are
timed in turns (base, this, this, base) with CUDA events.  Where the base
cannot launch (mamba2-370m's shape needs 265,984 bytes of shared memory
unsplit) its CUDA error code is printed instead of a time.  Prints one
JSON line a shape -- both times, whether the two outputs are bit for bit
the same, and this kernel's largest difference from the plain chunked
version -- then the card's name and power limit.  Needs a CUDA card;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402

# (H, P, N) of each arch's scan; B = 4, S = 512, chunk 128
SHAPES = {"zamba2-7b": (112, 64, 64), "mamba2-370m": (32, 64, 128)}
B, S, Q = 4, 512, 128


def library(source: Path) -> ctypes.CDLL:
    """``source``'s library, with the number of pointers and leading ints
    its ``ssd_scan_launch`` takes (``lib.signature``): the forward's
    route and scratch (``ssd_scan_fwd_route`` exported) 11 and 3, the
    chunk-state output (a backward exported) 9 and 1, else 8 and 1."""
    (so, _), = _build.build_all([source])
    lib = ctypes.CDLL(str(so))
    lib.signature = (11, 3) if hasattr(lib, "ssd_scan_fwd_route") else \
        (9, 1) if hasattr(lib, "ssd_scan_bwd_launch") else (8, 1)
    ptrs, ints = lib.signature
    lib.ssd_scan_launch.argtypes = [ctypes.c_void_p] * ptrs + \
        [ctypes.c_int] * (ints + 6) + [ctypes.c_longlong] * 6 + \
        [ctypes.c_void_p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def launcher(lib, xh, dt, A, Bm, Cm, init, y, final):
    """A call of ``lib``'s f32 kernel on these buffers (no chunk states:
    null pointers; dtype 0, the rule's route, no states); returns its
    CUDA error code (0 when it launched)."""
    H, P = xh.shape[2], xh.shape[3]
    N = Bm.shape[-1]
    strides = ssd_kernel.token_strides(xh, Bm, Cm)
    ptrs, ints = lib.signature
    lead = (0, -1, 0)[:ints]

    def call() -> int:
        return lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), init.data_ptr(), y.data_ptr(), final.data_ptr(),
            *(None,) * (ptrs - 8), *lead, B, S, H, P, N, Q, *strides,
            torch.cuda.current_stream().cuda_stream)
    return call


def cuda_ms(call, iters: int) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_source", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_f32_turns: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = {"base": library(args.base_source),
            "this": library(ssd_kernel.SOURCE)}
    for arch, (H, P, N) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        xh = torch.randn((B, S, H, P), generator=g, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=g, device=dev))
        A = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
        Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev) * 0.5
                  for _ in range(2))
        init = torch.zeros((B, H, P, N), device=dev)
        outs, calls, errors = {}, {}, {}
        for tag, lib in libs.items():
            outs[tag] = (torch.full_like(xh, float("nan")),
                         torch.full_like(init, float("nan")))
            calls[tag] = launcher(lib, xh, dt, A, Bm, Cm, init, *outs[tag])
            errors[tag] = calls[tag]()
            torch.cuda.synchronize()
        times = {tag: [] for tag in libs}
        for tag in ("base", "this", "this", "base"):
            if errors[tag] == 0:
                times[tag].append(cuda_ms(calls[tag], args.iters))
        ry, rf = ssd_chunked(xh, dt, A, Bm, Cm, Q, init_state=init)
        y, final = outs["this"]
        print(json.dumps({
            "arch": arch, "shape": [B, S, H, P, N, Q], "dtype": "float32",
            "base_ms": times["base"], "this_ms": times["this"],
            "launch_error": errors,
            "f32_slice_p": ssd_kernel.f32_slice_p(Q, P, N),
            "identical": errors["base"] == 0 and all(
                torch.equal(a, b) for a, b in zip(outs["base"], outs["this"])),
            "this_vs_chunked": max(float((y - ry).abs().max()),
                                   float((final - rf).abs().max()))}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
