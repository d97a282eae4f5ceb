"""Run one cell of the benchmark once, on the machine this starts on.

    python3 bench/run.py --workload qwen3-1.7b.train-4k --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout (the program is imported from its ``src``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number the comparison with the
reference read, beside its limit.  The same numbers end standard error.
It exits nonzero, printing no result, without the CUDA devices the cell
asks for, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 without it)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()
BANNED = ("jax", "jaxlib", "flax", "repro")


def clock() -> float:
    """Seconds since the process started."""
    return _AGE0 + time.perf_counter() - _T0


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, the whole name compared (``repro_torch`` is not
    ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(BANNED))


def prepare(root: Path) -> None:
    """The import paths and the caches' directories, inside the checkout
    at fixed paths; the port's kernels build into its own
    ``build/repro_torch_kernels``."""
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = root / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # training on the card is deterministic, which cuBLAS must know
    # before it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             count: int = 1) -> tuple:
    """One run of ``spec``'s cell: the driver's window, the metrics read
    from it, then the comparison with the reference.  Returns the result
    line's object and the comparison's further readings."""
    import torch

    from bench.harness.judge import verdict
    rec = spec.driver().run(spec, seed, seconds, trace, device, clock)
    rec["model"] = spec.config["model"]
    metrics = {}
    for e in spec.metrics(trace):
        v = spec.reader(e["name"])(rec)
        if v is not None:
            metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}
    t_check = clock()
    numbers = rec["check"]()
    numbers.setdefault("_readings", {}).update(
        setup_s=rec["setup_s"], **rec["parts"],
        window_s=rec["window_s"], check_s=clock() - t_check,
        total_s=clock())
    if rec.get("trace"):
        numbers["_readings"]["trace_read_s"] = rec["trace"]["read_s"]
    correct, checks = verdict(numbers, spec.limits())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": count, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = checks
    return out, {k: numbers[k] for k in ("_readings", "_where")
                 if k in numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    prepare(root)
    from bench.harness.cells import Spec
    spec = Spec(root, args.workload)
    import torch
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out, extra = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), count=chips)
    found = banned_modules()
    if found:
        print(f"loaded and not allowed in a run: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"readings": extra}, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
