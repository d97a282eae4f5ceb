"""The port's dry-run (``repro_torch.launch.cells``/``dryrun``) and
roofline (``repro_torch.roofline.analysis``) against the reference's on
the CPU: the cell list, every full-size cell's argument bytes in all and
per device on both production layouts (exactly), the counted flops of a
tiny prefill against a hand count (exactly) and of tiny cells against
XLA's cost analysis of the reference's (within a measured band), the
roofline's formulas, the kernels' meta branches and the CLI.  The
reference builds its cells on abstract meshes from shapes alone; the
port's are meta tensors: nothing full-size is allocated or run."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

import chip_smoke as cs
import repro.roofline.analysis as RRA
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.configs.registry import cells as rcells
from repro.configs.registry import get_arch as rget_arch
from repro.configs.registry import tiny as rtiny
from repro.launch.cells import lower_cell as rlower_cell
from repro.launch.cells import make_cell as rmake_cell
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS, cells, get_arch, tiny
from repro_torch.kernels import work as W
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.ssd_scan import ops as SSD
from repro_torch.launch import cells as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     Mesh, make_card_mesh)
from repro_torch.roofline import analysis as RA

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = {"single": ((16, 16), ("data", "model")),
           "multi": ((2, 16, 16), ("pod", "data", "model"))}


def test_cells_match_reference():
    got = [(a.name, s.name, skip) for a, s, skip in cells()]
    want = [(a.name, s.name, skip) for a, s, skip in rcells()]
    assert got == want
    assert len(got) == 40 and sum(s for *_, s in got) == 7


def _ref_arg_bytes(cell) -> int:
    """The reference cell's argument shard bytes on one device."""
    leaves = jax.tree.leaves(cell.args)
    shs = jax.tree.leaves(cell.in_shardings,
                          is_leaf=lambda x: hasattr(x, "shard_shape"))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
               for l, s in zip(leaves, shs))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_match_reference(arch):
    """Every shape of ``arch`` at full size: the port's meta arguments
    (parameters, optimizer state, batch, caches, step) hold the bytes of
    the reference's ``make_cell(...).args``, and on both production
    layouts each device's shard bytes equal the reference's
    ``shard_shape`` bytes, exactly.  A skipped cell (a full-attention
    arch at long_500k) is held to its total only: its caches do not
    shard on either side."""
    for shape in SHAPES:
        skipped = shape in ARCHS[arch].skip_shapes
        for layout, (sizes, names) in LAYOUTS.items():
            ref = rmake_cell(arch, shape, AbstractMesh(sizes, names))
            cell = C.make_cell(arch, shape, Mesh(names, sizes))
            got = sum(C._nbytes(t) for a in cell.args for t in C.leaves(a))
            assert got == sum(int(np.prod(l.shape)) * l.dtype.itemsize
                              for l in jax.tree.leaves(ref.args)), \
                (arch, shape, layout)
            if not skipped:
                assert C.argument_bytes_per_device(cell) == \
                    _ref_arg_bytes(ref), (arch, shape, layout)
            assert cell.donate_argnums == ref.donate_argnums


def _lower(cfg, shape):
    mesh = make_card_mesh()
    return C.lower_cell(C.make_cell(cfg, shape, mesh), mesh)


def test_prefill_flops_equal_a_hand_count():
    """A tiny dense prefill counts its products and nothing else: the
    projections, the MLP, the attention kernel's formula (2 * 2 * dh a
    visible pair a head) and the last token's logits."""
    cfg = tiny(get_arch("qwen3-1.7b"))
    B, S = 2, 16
    lo = _lower(cfg, ShapeConfig("p", S, B, "prefill"))
    D, H, K, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    V = -(-cfg.vocab // 128) * 128
    T = B * S
    per_layer = (2 * T * D * H * dh + 2 * 2 * T * D * K * dh
                 + 2 * T * H * dh * D + 3 * 2 * T * D * F
                 + 4 * dh * B * H * S * (S + 1) // 2)
    want = cfg.n_layers * per_layer + 2 * B * D * V
    assert lo.cost_analysis()["flops"] == want
    assert lo.kernels["flash_attention"]["calls"] == cfg.n_layers


# port flops / XLA flops of the reference's same tiny cell: XLA also
# counts elementwise work (norms, rotary embedding, softmax, the
# optimizer's update), which the port's count (the products through
# FlopCounterMode and the kernels' formulas) leaves out, so the port
# counts less.  Measured on these cells: 0.854 (mamba2-370m decode) to
# 0.991 (the MoE decodes).
XLA_BAND = (0.80, 1.0)
# zamba2-7b: the reference runs its shared attention block under a
# lax.cond in every layer, and XLA counts it in all 7 tiny layers; the
# port runs it in the 2 where it is used.  Measured: 0.526-0.528.
XLA_BAND_HYBRID = (0.50, 0.56)
XLA_CELLS = [("qwen3-1.7b", "train"), ("zamba2-7b", "prefill"),
             ("qwen2-moe-a2.7b", "prefill"), ("mamba2-370m", "prefill"),
             ("whisper-medium", "prefill"), ("internvl2-26b", "prefill"),
             ("gemma3-27b", "decode"), ("arctic-480b", "decode")]


@pytest.mark.parametrize("arch,kind", XLA_CELLS)
def test_flops_against_xla_cost_analysis(arch, kind):
    n = {"train": 4, "prefill": 2, "decode": 2}[kind]
    rmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    rcfg = rtiny(rget_arch(arch), scan_layers=False)
    compiled = rlower_cell(rmake_cell(rcfg, RShapeConfig("c", 64, n, kind),
                                      rmesh), rmesh).compile()
    xla = compiled.cost_analysis()["flops"]
    got = _lower(tiny(get_arch(arch)), ShapeConfig("c", 64, n, kind)
                 ).cost_analysis()["flops"]
    lo, hi = XLA_BAND_HYBRID if arch == "zamba2-7b" else XLA_BAND
    assert lo <= got / xla <= hi, (arch, kind, got, xla, got / xla)


def test_memory_analysis_of_a_train_cell():
    """The arguments are the parameters, AdamW's moments, the batch and
    the step; the outputs alias the donated parameters and moments (the
    update is in place) and add the loss; the temp bytes are positive."""
    cfg = tiny(get_arch("qwen3-1.7b"))
    mesh = make_card_mesh()
    cell = C.make_cell(cfg, ShapeConfig("t", 32, 4, "train"), mesh)
    params, opt = cell.args[0], cell.args[1]
    p_bytes = sum(C._nbytes(p) for p in params.parameters())
    o_bytes = sum(C._nbytes(t) for t in C.leaves(opt))
    assert o_bytes == 2 * p_bytes           # f32 moments of f32 params
    mem = C.lower_cell(cell, mesh).memory_analysis()
    assert mem.argument_size_in_bytes == p_bytes + o_bytes + 4 * 4 * 33 + 4
    assert mem.alias_size_in_bytes == p_bytes + o_bytes
    assert mem.output_size_in_bytes == p_bytes + o_bytes + 4
    assert mem.temp_size_in_bytes > 0


def test_meta_branches_return_shapes_and_add_work():
    B, S, H, K, d = 2, 48, 4, 2, 32
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                  device="meta")
    q, k, v = m(B, S, H, d), m(B, S, K, d), m(B, S, K, d)
    with W.recording(W.Tally()) as t:
        o = FA.flash_attention(q, k, v, causal=True, window=16)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    w = FA.work(B, S, S, H, K, d, causal=True, window=16)
    assert t.by_kernel["flash_attention"] == {"calls": 1, **w}
    # a window of 16 over 48 tokens: 16 * 17 / 2 pairs, then 16 a query
    assert w["flops"] == 4 * d * B * H * (16 * 17 // 2 + 32 * 16)
    # under a gradient: the forward keeps its lse, the backward pair adds
    # its own work
    qg, kg, vg = (x.requires_grad_() for x in (m(B, S, H, d), m(B, S, K, d),
                                                m(B, S, K, d)))
    with W.recording(W.Tally()) as t:
        FA.flash_attention(qg, kg, vg, causal=True).sum().backward()
    assert qg.grad.shape == qg.shape and kg.grad.shape == kg.shape
    assert t.by_kernel["flash_attention"]["bytes"] == FA.work(
        B, S, S, H, K, d, causal=True, with_lse=True)["bytes"]
    bwd = FA.work(B, S, S, H, K, d, causal=True, backward=True)
    assert t.by_kernel["flash_attention_bwd"] == {"calls": 1, **bwd}
    assert bwd["flops"] == 2.5 * FA.work(B, S, S, H, K, d,
                                         causal=True)["flops"]

    P, N, Q = 16, 32, 16
    xh, Bm, Cm = m(B, S, H, P), m(B, S, N), m(B, S, N)
    dt, A = m(B, S, H, dt=torch.float32), m(H, dt=torch.float32)
    with W.recording(W.Tally()) as t:
        y, final = SSD.ssd_scan(xh, dt, A, Bm, Cm, chunk=Q)
    assert y.shape == xh.shape and final.shape == (B, H, P, N)
    assert final.dtype == torch.float32
    assert t.by_kernel["ssd_scan"] == {
        "calls": 1, **SSD.work(B, S, H, P, N, Q, itemsize=2)}
    xg = xh.requires_grad_()
    with W.recording(W.Tally()) as t:
        y, _ = SSD.ssd_scan(xg, dt, A, Bm, Cm, chunk=Q)
        y.sum().backward()
    assert xg.grad.shape == xh.shape
    assert t.by_kernel["ssd_scan_bwd"] == {
        "calls": 1, **SSD.work(B, S, H, P, N, Q, backward=True)}
    # the forward under a gradient writes the chunk states, as the
    # training path's kernel does
    fwd = SSD.work(B, S, H, P, N, Q, with_states=True)
    assert t.by_kernel["ssd_scan"]["bytes"] == fwd["bytes"]


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=g)
    with W.recording(W.Tally()) as t:
        FA.flash_attention(q, q, q, causal=True)
        x = torch.randn(1, 8, 2, 4, generator=g)
        SSD.ssd_scan(x, torch.rand(1, 8, 2, generator=g), -torch.ones(2),
                     torch.randn(1, 8, 4, generator=g),
                     torch.randn(1, 8, 4, generator=g), chunk=4)
    assert t.flops == t.bytes == 0 and not t.by_kernel


def test_roofline_matches_reference(monkeypatch):
    for arch, shape, _ in cells():
        rshape = RShapeConfig(**dataclasses.asdict(shape))
        assert RA.tokens_of(shape) == RRA.tokens_of(rshape)
        assert RA.model_flops(arch, shape) == RRA.model_flops(
            rget_arch(arch.name), rshape)
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "h100",
           "status": "ok", "argument_size_in_bytes": 20321594372,
           "temp_size_in_bytes": 1 << 40, "fits": False,
           "cost": {"flops": 1.5e16, "bytes_accessed": 8.8e13,
                    "collective_bytes": 0.0, "collective_detail": {}}}
    monkeypatch.setattr(RRA, "PEAK_FLOPS_BF16", PEAK_FLOPS_BF16)
    monkeypatch.setattr(RRA, "HBM_BW", HBM_BW)
    monkeypatch.setattr(RRA, "ICI_BW", NVLINK_BW)
    monkeypatch.setattr(RRA, "CHIPS", RA.CHIPS)
    want = RRA.analyze_cell(rec)
    got = RA.analyze_cell(rec)
    assert {k: got[k] for k in want} == want
    assert RA.analyze_cell({"status": "skipped"}) is None


def test_cli_runs_a_tiny_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one tiny cell in every
    layout, then the roofline over its h100 record."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         "tiny:qwen3-1.7b:prefill_32k,qwen3-1.7b:long_500k", "--mesh",
         "all", "--outdir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(recs) == 6
    h = recs["tiny-qwen3-1.7b__prefill_32k__h100.json"]
    assert h["status"] == "ok" and h["fits"] and h["n_devices"] == 1
    assert h["cost"]["flops"] > 0 and h["cost"]["collective_bytes"] == 0
    assert h["cost"]["kernels"]["flash_attention"]["calls"] == 4
    single = recs["tiny-qwen3-1.7b__prefill_32k__single.json"]
    assert single["n_devices"] == 256 and "cost" not in single
    assert 0 < single["argument_size_in_bytes"] < h["argument_size_in_bytes"]
    skip = recs["qwen3-1.7b__long_500k__h100.json"]
    assert skip["status"] == "skipped" and skip["reason"] == D.SKIP_REASON
    assert RA.main(["--dir", str(tmp_path)]) == 0
    table = json.loads((tmp_path / "roofline_torch.json").read_text())
    assert [r["shape"] for r in table["rows"]] == ["prefill_32k"]
    assert (tmp_path / "roofline_torch.md").exists()


def test_chip_smoke_dryrun_phase_logic():
    """``chip_smoke.py``'s dryrun phase: the cells it predicts (every
    served arch's prefill and decode, the four trained archs, the three
    depth cuts at full depth), and the checks it makes on a synthetic
    prediction: a cut predicted to fit fails, so do a cell the card ran
    predicted not to fit, parameter bytes other than the allocated, and
    allocated bytes outside the caching allocator's bounds."""
    cells = cs.dryrun_cells(cs.FULL)
    served = [n for n in cells if n.endswith(":serve_prefill")]
    assert len(served) == len(cs.SERVED_ARCHS) == 9
    cuts = {n: c[1].n_layers for n, c in cells.items() if c[0] == "cut"}
    assert cuts == {"zamba2-7b:train@81": 81, "qwen2-moe-a2.7b:train@24": 24,
                    "arctic-480b:serve_prefill@35": 35}
    assert cells["qwen3-1.7b:train"][2].global_batch == cs.FULL.train_batch
    assert not any(c[0] == "cut" for c in cs.dryrun_cells(cs.SMALL).values())

    def rec(role, fits=True, **kw):
        return {"role": role, "n_layers": 2, "argument_bytes": 10,
                "temp_bytes": 5, "total_bytes": 15, "fits": fits,
                "flops": 989e9, "bytes_accessed": 3.35e9, "trace_s": 0.1,
                **kw}
    pred = {n: rec(c[0], fits=c[0] != "cut") for n, c in cells.items()}
    pred["qwen3-1.7b:train"].update(param_bytes=4, opt_bytes=8,
                                    param_alloc_bytes=[512, 512 + 2**20],
                                    opt_alloc_bytes=[1024, 1024])
    runs = [{"arch": a, "peak_bytes": 30} for a in cs.SERVED_ARCHS]
    train = {"param_bytes": 4, "opt_bytes": 8, "param_alloc_bytes": 2**20,
             "opt_alloc_bytes": 1024, "peak_bytes": 30,
             "profile": {"device_ms": 4.0},
             **{a: {"peak_bytes": 30} for a in
                cs.SSM_TRAIN_ARCHS + (cs.MOE_TRAIN_ARCH,)}}
    fam = {"archs": runs[2:]}
    out = cs.run_dryrun(pred, runs[0], runs[1], fam, train, cs.FULL)
    assert len(out["ran"]) == 13 and len(out["cuts"]) == 3
    assert out["ran"][0]["measured_over_predicted"] == 2.0
    assert out["train_step"]["compute_term_ms"] == pytest.approx(1.0)
    assert out["train_step"]["compute_share"] == pytest.approx(0.25)
    assert out["allocated_bytes"]["param"]["over_tensors"] == 2**20 - 4
    for broken in ("cut", "ran", "bytes", "alloc"):
        bad = {n: dict(r) for n, r in pred.items()}
        if broken == "cut":
            bad["zamba2-7b:train@81"]["fits"] = True
        elif broken == "ran":
            bad["qwen2-7b:serve_decode"]["fits"] = False
        elif broken == "bytes":
            bad["qwen3-1.7b:train"]["opt_bytes"] = 9
        else:
            bad["qwen3-1.7b:train"]["opt_alloc_bytes"] = [1536, 2048]
        with pytest.raises(AssertionError):
            cs.run_dryrun(bad, runs[0], runs[1], fam, train, cs.FULL)


def test_chip_smoke_predicts_cells_in_worker_processes(monkeypatch):
    """The dryrun phase's cells traced in two spawned processes give the
    records one process gives, in the cells' order; a train cell's
    allocator bounds: its tensors' bytes rounded up to 512 each, and 1 MiB
    more for each tensor over 1 MiB."""
    names = ("qwen3-1.7b:train", "qwen2-7b:serve_prefill",
             "mamba2-370m:serve_decode")
    cells = {n: cs.dryrun_cells(cs.SMALL)[n] for n in names}
    monkeypatch.setattr(cs, "dryrun_cells", lambda sz: cells)
    strip = lambda pred: {n: {k: v for k, v in r.items() if k != "trace_s"}
                          for n, r in pred.items()}
    one = cs.predict_cells(cs.SMALL)
    two = cs.predict_cells(cs.SMALL, workers=2)
    assert list(two) == list(names) and strip(two) == strip(one)
    q = one["qwen3-1.7b:train"]
    params = cs.make_cell(*cells["qwen3-1.7b:train"][1:],
                          cs.make_card_mesh()).args[0]
    nbytes = [p.numel() * p.element_size() for p in params.parameters()]
    assert q["param_alloc_bytes"] == [
        sum(-(-n // 512) * 512 for n in nbytes),
        sum(-(-n // 512) * 512 + (n > 2**20) * 2**20 for n in nbytes)]
    assert q["param_bytes"] < q["param_alloc_bytes"][0]   # the 1-D norms
