"""Three-term roofline over the dry-run's records on one card (the port's
counterpart of ``repro.roofline.analysis``).

Per (arch x shape) cell, from the ``h100`` records of
:mod:`repro_torch.launch.dryrun`::

    compute term    = flops / PEAK_FLOPS_BF16                   [s]
    memory term     = bytes accessed / HBM_BW                   [s]
    collective term = collective bytes / NVLINK_BW = 0 on one card

The denominators are the H100 SXM5's datasheet figures
(:mod:`repro_torch.launch.mesh`).  Also ``MODEL_FLOPS`` = 6 N D (train)
or 2 N D (forward only), N the active parameters and D the step's
tokens; MODEL/traced exposes the remat recompute, the attention and the
padding; the roofline fraction is the useful compute's time over the
dominant term.

    python -m repro_torch.roofline.analysis [--dir build/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from ..configs.base import SHAPES
from ..configs.registry import get_arch
from ..launch.dryrun import DEFAULT_OUTDIR as DRYRUN_DIR
from ..launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

CHIPS = 1


def tokens_of(shape) -> int:
    if shape.kind in ("train", "prefill"):
        return shape.global_batch * shape.seq_len
    return shape.global_batch          # decode: one token per sequence


def model_flops(cfg, shape) -> float:
    """6 N D with MoE active parameters; forward-only cells 2 N D."""
    n = cfg.n_active_params()
    toks = tokens_of(shape)
    if shape.kind == "train":
        return 6.0 * n * toks
    return 2.0 * n * toks


def analyze_cell(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok" or "cost" not in rec:
        return None
    cfg = get_arch(rec["arch"])
    shape = SHAPES[rec["shape"]]
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    coll_dev = rec["cost"]["collective_bytes"]
    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mf_dev = mf / CHIPS
    useful_t = mf_dev / PEAK_FLOPS_BF16
    frac = useful_t / max(terms.values()) if max(terms.values()) else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_dev": mf_dev, "hlo_flops_dev": flops_dev,
        "model_over_hlo": mf_dev / flops_dev if flops_dev else 0.0,
        "roofline_fraction": frac,
        "temp_gb": rec.get("temp_size_in_bytes", 0) / 1e9,
        "args_gb": rec.get("argument_size_in_bytes", 0) / 1e9,
        "fits": rec.get("fits"),
        "collective_detail": rec["cost"].get("collective_detail", {}),
    }


def load_table(dryrun_dir=DRYRUN_DIR, mesh="h100"):
    rows, skips = [], []
    for p in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") == "skipped":
            skips.append(rec)
            continue
        row = analyze_cell(rec)
        if row:
            rows.append(row)
    return rows, skips


def render_markdown(rows, skips) -> str:
    out = ["| arch | shape | args GB | temp GB | fits | compute s | "
           "memory s | dominant | MODEL/traced | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['args_gb']:.1f} | "
            f"{r['temp_gb']:.1f} | {'yes' if r['fits'] else 'no'} | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
            f"**{r['dominant']}** | {r['model_over_hlo']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    if skips:
        out.append("")
        out.append(f"Skipped cells ({len(skips)}): " + ", ".join(
            f"{s['arch']}:{s['shape']}" for s in skips) +
            " (pure full-attention archs at 500k).")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    d = Path(args.dir)
    rows, skips = load_table(d)
    if not rows:
        print(f"no h100 records under {d}")
        return 1
    md = render_markdown(rows, skips)
    print(md)
    (d / "roofline_torch.md").write_text(md + "\n")
    (d / "roofline_torch.json").write_text(json.dumps(
        {"rows": rows, "skips": [{"arch": s["arch"], "shape": s["shape"]}
                                 for s in skips]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
