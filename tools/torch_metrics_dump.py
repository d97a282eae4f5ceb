#!/usr/bin/env python
"""Metrics snapshot CLI over the PyTorch port: inspect / merge / re-export
NVTrace snapshots.

Reads one or more JSON snapshots produced by
``repro_torch.obs.metrics.MetricsRegistry.snapshot`` (or the reference's:
the format is the same) (e.g. the
``OBS_metrics.json`` artifact the obs bench writes), merges them
(counters/histograms add — the cross-shard path), and prints either a
human summary (default), the merged snapshot JSON (``--json``), or
Prometheus text exposition (``--prom``).

  PYTHONPATH=src python tools/torch_metrics_dump.py OBS_metrics.json
  PYTHONPATH=src python tools/torch_metrics_dump.py shard*.json --prom
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    from repro_torch.obs.metrics import MetricsRegistry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshots", nargs="+", metavar="SNAP.json",
                    help="registry snapshot file(s); several merge")
    ap.add_argument("--prom", action="store_true",
                    help="print Prometheus text exposition")
    ap.add_argument("--json", action="store_true", dest="json_",
                    help="print the merged snapshot as JSON")
    ap.add_argument("--quantiles", default="0.5,0.99,0.999",
                    help="histogram quantiles for the summary table")
    args = ap.parse_args(argv)

    reg = MetricsRegistry()
    for path in args.snapshots:
        try:
            with open(path) as f:
                reg.merge_snapshot(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot read snapshot {path}: {e}",
                  file=sys.stderr)
            return 1

    if args.prom:
        sys.stdout.write(reg.to_prometheus())
        return 0
    if args.json_:
        json.dump(reg.snapshot(), sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0

    qs = [float(q) for q in args.quantiles.split(",") if q]
    for e in sorted(reg.entries(),
                    key=lambda e: (e.kind, e.name, sorted(e.labels.items()))):
        lbl = ",".join(f"{k}={v}" for k, v in sorted(e.labels.items()))
        lbl = f"{{{lbl}}}" if lbl else ""
        if e.kind in ("counter", "gauge"):
            print(f"{e.kind:9s} {e.name}{lbl} = {e.obj.value}")
        else:
            h = e.obj
            qtxt = " ".join(f"p{q * 100:g}={h.quantile(q):.3g}"
                            for q in qs)
            print(f"histogram {e.name}{lbl} count={h.count} "
                  f"sum={h.sum:.6g} {qtxt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
