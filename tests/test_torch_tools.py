"""The port's tools (``tools/torch_*.py``) against the reference's on the
CPU: ``torch_metrics_dump.py`` prints byte for byte what
``metrics_dump.py`` prints over the same snapshots in its three modes;
``torch_persist_lint.py --static`` reports the reference's violations
and waivers over the same tree; ``torch_crash_sweep.py`` gives the
reference's sites, runs and failures; ``torch_moe_dispatch_turns.py``
loads the other copy it times."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from repro_torch.obs.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def snapshots(tmp_path) -> list:
    paths = []
    for shard in range(2):
        reg = MetricsRegistry()
        reg.counter("commits", shard=str(shard)).inc(3 + shard)
        reg.counter("flushes").inc(10 * (shard + 1))
        reg.gauge("pool_fill", shard=str(shard)).set(0.25 * (shard + 1))
        h = reg.histogram("serve_request_us", lo=1.0, hi=1e6)
        for v in (3.0, 40.0, 41.0, 900.0 * (shard + 1), 12345.0):
            h.record(v)
        p = tmp_path / f"shard{shard}.json"
        p.write_text(json.dumps(reg.snapshot()))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("mode", [[], ["--json"], ["--prom"],
                                  ["--quantiles", "0.9,0.5"]])
def test_metrics_dump_matches_reference(mode, tmp_path, capsys):
    snaps = snapshots(tmp_path)
    ref, port = load("metrics_dump"), load("torch_metrics_dump")
    assert ref.main(snaps + mode) == 0
    want = capsys.readouterr().out
    assert port.main(snaps + mode) == 0
    got = capsys.readouterr().out
    assert got == want and got
    assert port.main([str(tmp_path / "missing.json")]) == 1


def test_persist_lint_static_matches_reference(tmp_path, capsys):
    from repro.analysis.persistlint import run_static as ref_run_static
    ref, port = load("persist_lint"), load("torch_persist_lint")
    want_p, got_p = tmp_path / "ref.json", tmp_path / "port.json"
    assert ref.main(["--static", "--json", str(want_p)]) == 0
    # the reference's tree through the port's lint
    assert port.main(["--static", "--root", str(ROOT / "src/repro"),
                      "--json", str(got_p)]) == 0
    want, got = json.loads(want_p.read_text()), json.loads(got_p.read_text())
    assert got == want
    # the port's own tree, through both lints
    assert port.main(["--static", "--json", str(got_p)]) == 0
    got = json.loads(got_p.read_text())["static"]
    want = ref_run_static(ROOT / "src/repro_torch").to_dict()
    assert got == want
    assert got["violations"] == [] and got["n_waived"] >= 1
    capsys.readouterr()


def test_crash_sweep_matches_reference(tmp_path, monkeypatch, capsys):
    args = ["--layers", "log", "--budget", "4", "--evict", "none,torn"]
    ref, port = load("crash_sweep"), load("torch_crash_sweep")
    monkeypatch.setattr(sys, "argv", ["crash_sweep.py", *args, "--json",
                                      str(tmp_path / "ref.json")])
    assert ref.main() == 0
    assert port.main(args + ["--device", "cpu", "--json",
                             str(tmp_path / "port.json")]) == 0
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    for key in ("budget", "seed", "evict_modes", "shards"):
        assert got[key] == want[key]
    for layer, rep in want["layers"].items():
        mine = got["layers"][layer]
        for key in ("n_sites", "tested_sites", "runs", "failures",
                    "evict_modes"):
            assert mine[key] == rep[key], (layer, key)
        assert [(s["kind"], s["target"]) for s in mine["sites"]] == \
            [(s["kind"], s["target"]) for s in rep["sites"]]
    assert got["layers"]["log"]["failures"] == []
    out = capsys.readouterr().out
    assert "layer=log        sites= 29 tested=  4 runs=  8 failures=0 ok" \
        in out


def test_crash_sweep_lists_sites_and_shards_the_log(capsys):
    port = load("torch_crash_sweep")
    assert port.main(["--layers", "log", "--list", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 29
    assert port.main(["--layers", "log2", "--shards", "2", "--budget", "2",
                      "--evict", "torn", "--device", "cpu"]) == 0
    assert "layer=log2" in capsys.readouterr().out


def test_moe_dispatch_turns_loads_a_copy_and_needs_a_card(tmp_path):
    """``torch_moe_dispatch_turns.py`` loads another copy of ``moe.py`` as
    a module of the package (its relative imports resolve) whose FFN gives
    the port's bits; without a card it raises."""
    import torch
    from repro_torch.configs.registry import get_arch, tiny
    from repro_torch.models import moe
    tool = load("torch_moe_dispatch_turns")
    copy = tmp_path / "moe_base.py"
    copy.write_text((ROOT / "src/repro_torch/models/moe.py").read_text())
    base = tool.load_base(copy)
    cfg = tiny(get_arch("qwen2-moe-a2.7b"))
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(moe.moe_ffn(p, x, cfg),
                                                base.moe_ffn(p, x, cfg)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([str(copy)])
