"""Readings the comparison's limits are set from, made on the card at a
cell's own size (the benchmark's runs never run this):

* the program's numbers on every ``--seeds`` seed: its lower readings;
* on every ``--control-seeds`` seed, the control: the reference computed
  in float8 in the program's place (for a served cell, the gap of the
  token the float8 reference puts first at each served position);
* on the same seeds, the planted faults a cell can have that need a run:
  for a training cell half of each batch left out (the reference on half
  the rows in the program's place; a state left unchanged reads 1 by the
  measure and needs none), for a served cell one served token of each
  request altered.

    python3 bench/control.py --workload qwen3-1.7b.train-4k \\
        --seeds 11,12,... --control-seeds 11,12,13 --out readings.json

Every reading is printed as a JSON line, and the summary (each number's
largest program reading, smallest control and fault readings) last.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench.run import clock, prepare  # noqa: E402


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def train_readings(spec, seed: int, device, control: bool) -> list:
    from bench.harness import train
    t = train.Trainer(spec, seed, device)
    prog = t.prog
    t.close()
    nums, ref = train.reference(spec, seed, device, prog)
    out = [("program", nums)]
    if control:
        out.append(("control", train.reference(spec, seed, device, None,
                                               prec="fp8", ref=ref)[0]))
        half = spec.config["train"]["global_batch"] // 2
        out.append(("half_batch", train.reference(
            spec, seed, device, None, rows_kept=half, ref=ref)[0]))
    return out


def serve_readings(spec, seed: int, device, control: bool,
                   seconds: float) -> list:
    from bench.harness import serve
    rec = serve.run(spec, seed, seconds, False, device, clock)
    sample, faults = rec["sample"], rec["log_faults"]
    nums = serve.check(spec, seed, device, sample, faults, control=control)
    out = [("program", nums)]
    if control:
        out.append(("control", {"served_gap": nums["control_gap"],
                                "log_faults": faults}))
        vocab = spec.config["model"]["vocab"]
        altered = [(p, [t if i != 1 else (t + 1) % vocab
                        for i, t in enumerate(sv)]) for p, sv in sample]
        out.append(("altered_token", serve.check(spec, seed, device,
                                                 altered, faults)))
    return out


def summarize(rows: list) -> dict:
    out = {}
    for who, _, nums in rows:
        for k, v in nums.items():
            if k.startswith("_"):
                continue
            d = out.setdefault(k, {})
            agg = max if who == "program" else min
            d[who] = v if who not in d else agg(d[who], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="a served cell's window: one call at least")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path.cwd()
    prepare(root)
    import torch

    from bench.harness.cells import Spec
    spec = Spec(root, args.workload)
    device = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        ctl = seed in args.control_seeds
        got = train_readings(spec, seed, device, ctl) if spec.kind == "train" \
            else serve_readings(spec, seed, device, ctl, args.seconds)
        for who, nums in got:
            rows.append((who, seed, nums))
            print(json.dumps({"who": who, "seed": seed, "numbers": nums},
                             default=str), flush=True)
    summary = summarize(rows)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"rows": rows, "summary": summary}, default=str, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
