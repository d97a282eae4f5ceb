"""Dry-run of every (architecture x input shape x layout) cell on the meta
device (the port's counterpart of ``repro.launch.dryrun``).

For each cell the step is built from shapes alone
(:func:`repro_torch.launch.cells.make_cell`) and, on one card, run once
on meta tensors under counting modes (:func:`~repro_torch.launch.cells.
lower_cell`): its memory (arguments, outputs, donated outputs and the
peak of the rest) and its cost (flops, bytes moved), written as one JSON
record a cell.

Layouts (``--mesh``):

  * ``h100`` (the default): one card, ``n_devices`` 1.  The memory and
    cost passes run at full depth: the reference extrapolates from two
    reduced depths only because XLA counts a scanned loop's body once,
    and an eager run has no such loop.  The whole step is traced, every
    microbatch of a train step included, so nothing is extrapolated.  No
    collective runs on one card: the collective terms are 0.  A record
    ``fits`` when argument + output - alias + temp <= ``HBM_BYTES`` (an
    output written into a donated argument counted once).
  * ``single`` / ``multi``: the reference's 16 x 16 and 2 x 16 x 16
    layouts.  Only the arguments' memory: each argument's shard bytes on
    one device, from :mod:`repro_torch.sharding.specs`.  No compiler
    partitions the activations here, so there is no temp size, and no
    cost pass (the reference has none for ``multi`` either).

The reference's ``parse_collectives`` reads XLA's partitioned HLO text;
the port has no HLO and no counterpart.

Usage::

    python -m repro_torch.launch.dryrun --cells all --mesh h100
    python -m repro_torch.launch.dryrun --cells gemma3-27b:train_4k --mesh all
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

SKIP_REASON = ("pure full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")
MESHES = ("h100", "single", "multi")
DEFAULT_OUTDIR = "build/dryrun_torch"


def make_mesh(mesh_kind: str):
    from .mesh import make_card_mesh, make_production_mesh
    if mesh_kind == "h100":
        return make_card_mesh()
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def run_cell(arch_name, shape_name, mesh_kind: str) -> dict:
    """One cell's record.  ``arch_name``/``shape_name`` may be names
    (``tiny:NAME`` for an arch's reduced form) or (ArchConfig,
    ShapeConfig) instances (a reduced-depth cell)."""
    from ..configs.base import SHAPES
    from ..configs.registry import get_arch
    from .cells import argument_bytes_per_device, lower_cell, make_cell
    from .mesh import HBM_BYTES

    cfg = get_arch(arch_name) if isinstance(arch_name, str) else arch_name
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    rec = {"arch": arch_name if isinstance(arch_name, str) else cfg.name,
           "shape": shape.name, "mesh": mesh_kind}
    if shape.name in cfg.skip_shapes:
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    mesh = make_mesh(mesh_kind)
    rec["n_devices"] = mesh.size
    cell = make_cell(cfg, shape, mesh)
    if mesh_kind != "h100":
        rec["argument_size_in_bytes"] = argument_bytes_per_device(cell)
        rec["method"] = "argument shard bytes a device; no temp, no cost"
        rec["status"] = "ok"
        return rec

    lowered = lower_cell(cell, mesh)
    rec["trace_s"] = lowered.seconds
    mem = lowered.memory_analysis()
    for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes"):
        rec[attr] = int(getattr(mem, attr))
    total = mem.argument_size_in_bytes + mem.output_size_in_bytes \
        - mem.alias_size_in_bytes + mem.temp_size_in_bytes
    rec["total_bytes"] = total
    rec["fits"] = total <= HBM_BYTES
    cost = lowered.cost_analysis()
    M = lowered.microbatches
    rec["cost"] = {
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes accessed"],
        "collective_bytes": 0.0,
        "collective_detail": {},
        "kernels": lowered.kernels,
        "method": (f"the whole step traced on meta at full depth "
                   f"({M} microbatch{'es' if M > 1 else ''} and the "
                   f"update; nothing extrapolated); flops from "
                   f"FlopCounterMode plus the kernels' formulas, bytes "
                   f"each op's inputs and outputs; one card: no "
                   f"collectives"),
    }
    rec["status"] = "ok"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="all",
                    help="'all' or comma-separated arch:shape pairs "
                         "(tiny:arch:shape for an arch's reduced form)")
    ap.add_argument("--mesh", default="h100", choices=MESHES + ("all",))
    ap.add_argument("--outdir", default=DEFAULT_OUTDIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from ..configs.base import SHAPES
    from ..configs.registry import ARCHS

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.cells == "all":
        wanted = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    else:
        wanted = [tuple(c.rsplit(":", 1)) for c in args.cells.split(",")]
    meshes = MESHES if args.mesh == "all" else (args.mesh,)

    failures = 0
    for arch, shape in wanted:
        for mk in meshes:
            name = f"{arch.replace(':', '-')}__{shape}__{mk}"
            path = outdir / f"{name}.json"
            if args.skip_existing and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {name}: cached ({prev['status']})")
                    continue
            print(f"[dryrun] {name}: tracing...", flush=True)
            try:
                rec = run_cell(arch, shape, mk)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            path.write_text(json.dumps(rec, indent=1))
            print(f"[dryrun] {name}: {rec['status']} "
                  f"(trace {rec.get('trace_s', '-')} s)", flush=True)
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
