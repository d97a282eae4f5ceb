#!/usr/bin/env python3
"""Time edited copies of the port's bf16 tensor-core kernels against the
kernels as they are, on the card, at the zamba2-7b serve shapes.

    python3 tools/kernel_variants.py [--only ssd_scan|flash_attention]

Each variant is a list of text edits to a kernel's CUDA source: a part of
its work taken out (to see what that part costs) or a compiler hint
changed.  The edited copy is written under ``build/kernel_variants/``,
built like the kernel itself (``kernels/_build.py``) and loaded in place
of it; base and variant are timed in turns (base, variant, variant,
base) with CUDA events in one process, so they share one card and one
power state.  A variant that drops work computes a wrong result on
purpose: its ``max_abs_diff`` from the base output is printed beside its
time.  Prints one JSON line per variant with each build's registers and
spill bytes per compiled function, then the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402

OUT_DIR = ROOT / "build" / "kernel_variants"


def _drop(*lines: str):
    """An edit that removes these consecutive source lines."""
    text = "".join(line + "\n" for line in lines)
    return (text, "")


SSD_VARIANTS = {
    # C B^T: the two mma of each G tile
    "no_CBt": [_drop("          tc::mma(gs[0], cf[ks], bk[0], bk[1]);",
                     "          tc::mma(gs[1], cf[ks], bk[2], bk[3]);")],
    # the low parts of the three split operands
    "no_low_parts": [
        _drop("          tc::mma(acc[2 * pp], cf[ks], lo[0], lo[1]);",
              "          tc::mma(acc[2 * pp + 1], cf[ks], lo[2], lo[3]);"),
        _drop("          tc::mma(acc[2 * pp], sl, bx[0], bx[1]);",
              "          tc::mma(acc[2 * pp + 1], sl, bx[2], bx[3]);"),
        _drop("          tc::mma(st[2 * ks], xa, lo[0], lo[1]);",
              "          tc::mma(st[2 * ks + 1], xa, lo[2], lo[3]);")],
    # C S^T, both parts
    "no_CSt": [
        _drop("          tc::mma(acc[2 * pp], cf[ks], hi[0], hi[1]);",
              "          tc::mma(acc[2 * pp + 1], cf[ks], hi[2], hi[3]);",
              "          tc::mma(acc[2 * pp], cf[ks], lo[0], lo[1]);",
              "          tc::mma(acc[2 * pp + 1], cf[ks], lo[2], lo[3]);")],
    # the state update's products, both parts
    "no_state_update": [
        _drop("          tc::mma(st[2 * ks], xa, hi[0], hi[1]);",
              "          tc::mma(st[2 * ks + 1], xa, hi[2], hi[3]);",
              "          tc::mma(st[2 * ks], xa, lo[0], lo[1]);",
              "          tc::mma(st[2 * ks + 1], xa, lo[2], lo[3]);")],
    "no_unroll": [("#pragma unroll 2\n      for (int jk = 0; jk <= rb; ++jk)",
                   "      for (int jk = 0; jk <= rb; ++jk)")],
    "launch_bounds_1": [("__launch_bounds__(kTcThreads, 2)",
                         "__launch_bounds__(kTcThreads)")],
}
FLASH_VARIANTS = {
    "launch_bounds_3": [
        ("__global__ void __launch_bounds__(kTcThreads)\nflash_fwd_tc(",
         "__global__ void __launch_bounds__(kTcThreads, 3)\nflash_fwd_tc(")],
}


def cuda_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def registers(report: str) -> dict:
    """Registers and spill bytes per compiled function of a ``ptxas -v``
    report, keyed by readable name."""
    return {f.pop("kernel"): f
            for f in _build.ptxas_functions(report).values()}


def load(module, source: Path) -> dict:
    """Make ``module`` launch the library built from ``source``; returns
    that build's registers and spills."""
    module.SOURCE = source
    module._library.cache_clear()
    module._library()
    (_, report), = _build.build_all([source])
    return registers(report)


def run(module, variants: dict, call, iters: int) -> None:
    base = module.SOURCE
    text = base.read_text()
    ref = call().float()
    base_regs = registers(_build.build_all([base])[0][1])
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{base.name}: variant {name}: source text "
                                 f"not found:\n{old}")
            src = src.replace(old, new)
        path = OUT_DIR / f"{base.stem}_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        times = {"base": [], name: []}
        regs = {}
        for tag, p in (("base", base), (name, path), (name, path),
                       ("base", base)):
            regs[tag] = load(module, p)
            if tag == name:
                diff = float((call().float() - ref).abs().max())
            times[tag].append(cuda_ms(call, iters))
        print(json.dumps({"kernel": base.stem, "variant": name,
                          "base_ms": times["base"], "variant_ms": times[name],
                          "max_abs_diff": diff,
                          "base_build": base_regs,
                          "variant_build": regs[name]}), flush=True)
    load(module, base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("ssd_scan", "flash_attention"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    if args.only in (None, "ssd_scan"):
        B, S, H, P, N, Q = 4, 512, 112, 64, 64, 128
        xh = rnd(B, S, H, P).bfloat16()
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H) * 0.3)
        Bm, Cm = ((rnd(B, S, N) * 0.5).bfloat16() for _ in range(2))
        init = torch.zeros((B, H, P, N), device=dev)
        run(ssd_kernel, SSD_VARIANTS, lambda: ssd_kernel.ssd_scan_kernel(
            xh, dt, A, Bm, Cm, chunk=Q, init_state=init)[0], args.iters)
    if args.only in (None, "flash_attention"):
        q, k, v = (rnd(4, 512, 32, 112).bfloat16() for _ in range(3))
        run(fa_kernel, FLASH_VARIANTS,
            lambda: fa_kernel.flash_attention_kernel(q, k, v), args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
