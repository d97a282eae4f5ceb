#!/usr/bin/env python3
"""Time edited copies of the port's kernels against the kernels as they
are, on the card: the bf16 tensor-core kernels at the zamba2-7b serve
shapes, ``nvt_probe`` at the map shape (2^20 queries over 2^20 x 32
tiles).

    python3 tools/kernel_variants.py \
        [--only ssd_scan|flash_attention|nvt_probe]

Each variant is a list of text edits to a kernel's CUDA source: a part of
its work taken out (to see what that part costs), a compiler hint
changed, or a design choice swapped for the alternative it was chosen
over.  The edited copy is written under ``build/kernel_variants/``,
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.nvt_probe import kernel as probe_kernel  # noqa
from repro_torch.kernels.nvt_probe.ref import tiles_from_keys  # noqa: E402
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
# nvt_probe's design choices: the alternatives to the committed source
_FAST_MOD_SETUP = """\
  const int fm_l = 32 - __clz(n_buckets - 1);        // ceil(log2 NB)
  const unsigned fm_magic = (unsigned)(
      ((1ull << 32) * ((1ull << fm_l) - n_buckets)) / n_buckets + 1);
"""
_FAST_MOD = """\
    const unsigned h = mix32((unsigned)q), t = __umulhi(fm_magic, h);
    const unsigned b = h - ((t + ((h - t) >> (fm_l > 0))) >>
                            (fm_l > 0 ? fm_l - 1 : 0)) * n_buckets;
"""


def _hinted_load(hints: str):
    """Words<4>::load as ``ld.global.nc`` with these PTX cache hints."""
    return [("static __device__ __forceinline__ T load(const T* p) "
             "{ return __ldg(p); }\n  // bit e",
             "static __device__ __forceinline__ T load(const T* p) {\n"
             "    T v;\n    asm volatile(\"ld.global.nc" + hints +
             ".v4.s32 {%0,%1,%2,%3}, [%4];\"\n"
             "        : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), "
             "\"=r\"(v.w) : \"l\"(p));\n    return v;\n  }\n  // bit e")]


PROBE_VARIANTS = {
    # rows in flight per warp at cap 32: 8 and 16 instead of all 32
    "rows_in_flight_8": [("kWaveWords = 32;", "kWaveWords = 8;")],
    "rows_in_flight_16": [("kWaveWords = 32;", "kWaveWords = 16;")],
    "load_hints": _hinted_load(".L1::no_allocate.L2::128B"),
    "hint_l1_no_allocate": _hinted_load(".L1::no_allocate"),
    "hint_l2_128b": _hinted_load(".L2::128B"),
    "rows_ldcg": [("T load(const T* p) { return __ldg(p); }\n  // bit e",
                   "T load(const T* p) { return __ldcg(p); }\n  // bit e")],
    # % NB by a multiply-high (Granlund and Montgomery's round-up method)
    "fast_mod": [("  const int nvec = cap / VEC;\n",
                  "  const int nvec = cap / VEC;\n" + _FAST_MOD_SETUP),
                 ("    const unsigned b = mix32((unsigned)q) % n_buckets;\n",
                  _FAST_MOD)],
    "no_query_prefetch": [
        ("    const int q = q_next;                 // the next batch's in "
         "flight\n    q_next = load_query(queries, batch + stride, lane, "
         "n_queries);\n",
         "    const int q = load_query(queries, batch, lane, n_queries);\n")],
    "min_blocks_1": [("kMinBlocks = 3;", "kMinBlocks = 1;")],
    "min_blocks_4": [("kMinBlocks = 3;", "kMinBlocks = 4;")],
    "warps_4": [("kWarps = 8;", "kWarps = 4;")],
    "warps_16": [("kWarps = 8;", "kWarps = 16;")],
    # the value row fetched beside the key row (into L1, so the hit
    # values' own-lane loads find it there), against the dependent reads
    "vals_beside_keys": [
        ("          kv[i] = ok ? W::load(kt + (size_t)br[i] * nvec + v) : "
         "W::zero();\n",
         "          kv[i] = ok ? W::load(kt + (size_t)br[i] * nvec + v) : "
         "W::zero();\n          if (ok) asm volatile(\"prefetch.global.L1 "
         "[%0];\" :: \"l\"(vals + ((size_t)br[i] * nvec + v) * VEC));\n")],
    # aligned rows read as 4-byte words: one row a load instruction
    "word_loads": [("  const cudaStream_t st = (cudaStream_t)stream;\n",
                    "  const cudaStream_t st = (cudaStream_t)stream;\n"
                    "  if (vec == 4) {\n    vec = 1;\n"
                    "    lanes = lanes * 4 > 32 ? 32 : lanes * 4;\n"
                    "    chunks = (cap + lanes - 1) / lanes;\n  }\n")],
    # one batch a warp, as many blocks as batches need
    "grid_per_batch": [("  const int grid = (int)(need < most ? need : most);",
                        "  const int grid = (int)need;")],
    # what the value reads cost (wrong sums on purpose)
    "no_value_loads": [("sum += hit_values(my_vals + c * L * VEC, mine);",
                        "sum += mine;")],
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


def _flat(out) -> torch.Tensor:
    """A kernel's output (a tensor or a tuple of them) as one f32 vector."""
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([t.float().flatten() for t in outs])


def run(module, variants: dict, call, iters: int) -> None:
    base = module.SOURCE
    text = base.read_text()
    ref = _flat(call())
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
                diff = float((_flat(call()) - ref).abs().max())
            times[tag].append(cuda_ms(call, iters))
        print(json.dumps({"kernel": base.stem, "variant": name,
                          "base_ms": times["base"], "variant_ms": times[name],
                          "max_abs_diff": diff,
                          "base_build": base_regs,
                          "variant_build": regs[name]}), flush=True)
    load(module, base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("ssd_scan", "flash_attention",
                                       "nvt_probe"))
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
    if args.only in (None, "nvt_probe"):
        # the map's shape: 2^22 keys in 2^20 rows of 32, 2^20 uniform
        # queries over twice the key range (0 and -1 among them)
        rng = np.random.default_rng(1)
        kt, vt = tiles_from_keys(np.arange(1, 2**22 + 1), 2**20, 32,
                                 device=dev)
        q = torch.as_tensor(rng.integers(1, 2**23, size=2**20).astype(
            np.int32), device=dev)
        q[:2] = torch.tensor([0, -1], device=dev)
        run(probe_kernel, PROBE_VARIANTS,
            lambda: probe_kernel.nvt_probe_kernel(kt, vt, q), args.iters)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
