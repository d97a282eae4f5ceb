"""Crash-fault-injection sweep over the six durable-layer scenarios of the
PyTorch port.

Drives :mod:`repro_torch.robustness.faultinject` (its maps on the card,
or on ``--device``): for each selected layer the
scenario is run once crash-free to enumerate every persistence site
(flush / fence / publish / trim), then re-run with a deterministic
crash injected at each site (or an evenly spaced ``--budget`` subset,
first and last site always included) under each ``--evict`` adversary
mode, and the recovery invariants are checked after every crash: no
acknowledged op lost, prefix durability, oracle equivalence.

    PYTHONPATH=src python tools/torch_crash_sweep.py
    PYTHONPATH=src python tools/torch_crash_sweep.py --layers log,migrate \
        --budget 12 --evict none,random --json CRASH_sweep.json
    PYTHONPATH=src python tools/torch_crash_sweep.py --list --device cpu

Exit status is nonzero if any site × eviction-mode run violates an
invariant.  ``--shards N`` sizes the rebalance layer's mesh *and* — for
N > 1 — runs the ``log``/``log2`` scenarios with their dedup index on
the sharded durable-map backend (``log_shards``-style serving); the N
shards share one device.  ``--evict`` accepts the
``torn`` partial-write adversary alongside ``none``/``random``: evicted
staged files land truncated or garbled, and recovery must treat them
exactly like torn records.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    from repro_torch.core.batched import resolve_device
    from repro_torch.robustness.faultinject import (SCENARIOS,
                                                    enumerate_sites, sweep)

    ap = argparse.ArgumentParser(
        description="crash-at-every-site sweep over the durable layers")
    ap.add_argument("--layers", default=",".join(SCENARIOS),
                    help=f"comma list of {sorted(SCENARIOS)}")
    ap.add_argument("--budget", type=int, default=None,
                    help="max sites tested per layer per evict mode "
                         "(evenly spaced; default: every site)")
    ap.add_argument("--evict", default="none,random,torn",
                    help="comma list of eviction adversary modes "
                         "(none, random, torn)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the rebalance layer's map; > 1 also "
                         "runs log/log2 with a sharded dedup index")
    ap.add_argument("--list", action="store_true",
                    help="only enumerate and print the sites, no sweep")
    ap.add_argument("--json", default=None,
                    help="write the full report to this path")
    ap.add_argument("--device", default=None,
                    help="torch device of the scenarios' maps (default: "
                         "the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    layers = [l.strip() for l in args.layers.split(",") if l.strip()]
    unknown = [l for l in layers if l not in SCENARIOS]
    if unknown:
        ap.error(f"unknown layers {unknown}; choose from "
                 f"{sorted(SCENARIOS)}")
    evict_modes = [m.strip() for m in args.evict.split(",") if m.strip()]

    report = {"budget": args.budget, "seed": args.seed,
              "evict_modes": evict_modes, "shards": args.shards,
              "layers": {}}
    failed = False
    for layer in layers:
        if layer == "rebalance":
            kw = {"n_shards": args.shards, "device": dev}
        elif layer in ("log", "log2") and args.shards > 1:
            kw = {"shards": args.shards, "device": dev}
        else:
            kw = {"device": dev}
        if args.list:
            for s in enumerate_sites(SCENARIOS[layer], kw):
                print(f"{layer:10s} site {s.index:3d}  {s.kind:7s} "
                      f"{s.target}")
            continue
        rep = sweep(SCENARIOS[layer], budget=args.budget,
                    evict_modes=evict_modes, seed=args.seed,
                    scenario_kw=kw)
        report["layers"][layer] = rep
        ok = not rep["failures"]
        failed |= not ok
        print(f"layer={layer:10s} sites={rep['n_sites']:3d} "
              f"tested={len(rep['tested_sites']):3d} "
              f"runs={rep['runs']:3d} "
              f"failures={len(rep['failures'])} "
              f"{'ok' if ok else 'FAIL'}")
        for f in rep["failures"]:
            print(f"  FAIL site {f['site']} ({f['kind']} {f['target']}) "
                  f"evict={f['evict']}: {f['error']}", file=sys.stderr)
    if args.json and not args.list:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
