#!/usr/bin/env python3
"""Time the port's MoE FFN (``models/moe.py:moe_ffn``) of this checkout in
turns with another copy of that module (an earlier commit's), on one
card, at one layer of an MoE arch at full width.

    git show <rev>:src/repro_torch/models/moe.py > build/chip_scripts/moe_base.py
    python3 tools/torch_moe_dispatch_turns.py build/chip_scripts/moe_base.py

Both copies run on the same bf16 parameters and inputs at the serve
decode step ([4, 1] tokens), a serve prefill ([4, 512]) and a training
microbatch ([1, 4096], forward and backward of a scalar of the output and
the auxiliary loss).  Each round times ``--calls`` calls of one copy then
of the other, the order alternating by round, each call waited for on the
host, so a time is the host's wall time a call, host work included.
Prints one JSON line a shape -- each round's times, their medians, the
rounds this checkout won, and whether the two copies' outputs (and input
gradients) are bit for bit the same -- then the card's name and power
limit.  Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.batched import resolve_device  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# (batch, tokens, with a backward) of each shape
SHAPES = {"decode": (4, 1, False), "prefill": (4, 512, False),
          "train": (1, 4096, True)}


def load_base(path: Path):
    """The other copy of ``moe.py`` as a module of the same package, so
    that its relative imports resolve."""
    spec = importlib.util.spec_from_file_location(
        "repro_torch.models._moe_base", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="the other copy of moe.py")
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    base = load_base(args.base)
    cfg = get_arch(args.arch)
    p = moe.moe_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, (B, S, grad) in SHAPES.items():
        x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev,
                        dtype=torch.bfloat16)

        def call(mod):
            if not grad:
                with torch.no_grad():
                    return mod.moe_ffn(p, x, cfg)
            xr = x.detach().requires_grad_(True)
            y, aux = mod.moe_ffn(p, xr, cfg)
            (y.float().square().mean() + aux).backward()
            return y.detach(), xr.grad

        same = all(torch.equal(a, b) for a, b in zip(call(moe), call(base)))
        ms = {"this": [], "base": []}
        for r in range(args.rounds):
            for tag in (("base", "this") if r % 2 == 0 else ("this", "base")):
                mod = moe if tag == "this" else base
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    call(mod)
                    torch.cuda.synchronize()
                ms[tag].append((time.perf_counter() - t0) / args.calls * 1e3)
        print(json.dumps({
            "arch": cfg.name, "shape": name, "tokens": [B, S],
            "backward": grad, "bit_identical": same,
            "median_ms": {k: statistics.median(v) for k, v in ms.items()},
            "this_won": sum(a < b for a, b in zip(ms["this"], ms["base"])),
            "rounds": args.rounds, "ms": ms}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
