#!/usr/bin/env python
"""PersistLint CLI over the PyTorch port: static + trace-based
persistence-ordering analysis.

Runs the two `repro_torch.analysis` passes and exits nonzero on any
unwaived static violation or any fatal trace violation:

  * --static : AST lint of src/repro_torch, or of --root (raw-durable-io,
    publish-needs-fence, traverse-phase-persistence, crash-site-kinds;
    `# persistlint: waive(<rule>) — <why>` annotations honored and
    counted).
  * --trace  : record the full persistence-instruction stream of the
    six durable-layer faultinject scenarios in no-crash mode (their
    maps on the card, or on --device) and replay it against the
    ordering rules (missing-flush,
    publish-before-persist, traversal-phase-persistence fatal;
    redundant-flush / fence-with-nothing-pending reported non-fatal).

With neither flag, both passes run.  --layers narrows the trace pass;
--json writes the combined machine-readable report.

  PYTHONPATH=src python tools/torch_persist_lint.py --static --trace \
      --json out.json [--device cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    from repro_torch.analysis.checker import check_events
    from repro_torch.analysis.persistlint import run_static
    from repro_torch.analysis.trace import trace_scenario
    from repro_torch.core.batched import resolve_device
    from repro_torch.robustness.faultinject import SCENARIOS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--static", action="store_true", dest="static_",
                    help="run the AST lint over src/repro_torch")
    ap.add_argument("--root", default=None,
                    help="the tree the static pass lints (default: the "
                         "installed src/repro_torch)")
    ap.add_argument("--trace", action="store_true",
                    help="run the dynamic trace checker")
    ap.add_argument("--layers", default=",".join(SCENARIOS),
                    help="comma-separated trace layers "
                         f"(default: {','.join(SCENARIOS)})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the combined report as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device of the traced scenarios (default: "
                         "the card)")
    args = ap.parse_args(argv)
    if not args.static_ and not args.trace:
        args.static_ = args.trace = True

    report = {}
    fatal = 0

    if args.static_:
        sr = run_static(Path(args.root) if args.root else None)
        report["static"] = sr.to_dict()
        fatal += len(sr.violations)
        print(f"[static] {sr.n_files} files, "
              f"{len(sr.violations)} violation(s), "
              f"{len(sr.waived)} waiver(s)")
        for v in sr.violations:
            print(f"  VIOLATION {v.rule} {v.file}:{v.line} — {v.msg}")
        for v in sr.waived:
            print(f"  waived    {v.rule} {v.file}:{v.line}")

    if args.trace:
        layers = [s for s in args.layers.split(",") if s]
        unknown = [s for s in layers if s not in SCENARIOS]
        if unknown:
            ap.error(f"unknown layer(s) {unknown}; "
                     f"choose from {sorted(SCENARIOS)}")
        report["trace"] = {}
        dev = resolve_device(args.device)
        for layer in layers:
            tr = trace_scenario(layer, {"device": dev})
            rep = check_events(tr.events)
            report["trace"][layer] = rep.to_dict()
            fatal += len(rep.violations)
            print(f"[trace:{layer}] {rep.n_events} events, "
                  f"{len(rep.violations)} violation(s), "
                  f"{len(rep.diagnostics)} diagnostic(s)")
            for f in rep.violations:
                print(f"  VIOLATION {f.rule} @{f.index} "
                      f"{f.target} — {f.detail}")
            for f in rep.diagnostics:
                print(f"  diag      {f.rule} @{f.index} "
                      f"{f.target} — {f.detail}")

    report["ok"] = fatal == 0
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1))
        print(f"report -> {args.json}")
    print("persistlint:", "OK" if report["ok"] else f"{fatal} violation(s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
