"""``BENCHMARK.json`` against the benchmark's contract, the imports of
every module under ``bench/``, the harness's refusals, and a cell, a mix
and a metric added from new files and entries alone."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import families
from bench import run as bench_run
from bench.harness.cells import Spec

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"proj|head_size|expand|experts_per_tok")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["bench"] and b["command"][1].startswith("bench/")
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    confs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k), k
            run = conf["model"][k] if k in conf["model"] else \
                conf["train"][k]
            assert run != conf["reduced_from"][k]
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in confs and w["chips"] == 1 and _line(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in {
            (v["config"], v["traffic"]) for v in b["workloads"] if v is not w}
    assert used == set(confs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        spec = Spec(ROOT, w["name"])
        e = {m["name"] for m in spec.metrics(False)}
        assert "setup_s" in e and len(e) >= 2 and spec.metrics(True)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module)
    return tops


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` starts with
    ``repro`` and is allowed, except in the reference."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.parts:
        assert not tops & {"repro_torch"}
        assert not any(m.startswith("bench.harness") for m in _imports(path))


def test_the_reference_loads_nothing_of_the_program():
    """In a fresh process: the references load no JAX and nothing of the
    program, and the run's own check compares whole top-level names."""
    code = ("import json, sys; import bench.reference.dense, "
            "bench.reference.ssm, bench.reference.train, "
            "bench.reference.serve; from bench import run; "
            "mods = sorted({m.split('.')[0] for m in sys.modules}); "
            "sys.modules['repro_torch_x'] = sys; a = run.banned_modules(); "
            "sys.modules['repro.models'] = sys; b = run.banned_modules(); "
            "print(json.dumps([mods, a, b]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    mods, before, after = json.loads(out)
    assert not set(mods) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert before == [] and after == ["repro"]


def test_refuses_without_a_card_or_without_the_program(tmp_path):
    """No CUDA device: exit 2, nothing on standard output.  A directory
    with only BENCHMARK.json and the benchmark's files: nonzero, nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_new_config_mix_and_metric_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added by new
    files and new entries: the new cell runs and reports the new metric,
    with no file of the harness edited."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "bench/configs/qwen3-1.7b.json").read_text())
    conf["name"] = "qwen3-1.7b-wide"
    tiny = conf["tiny"]
    tiny["model"]["d_ff"] = tiny["arch_overrides"]["d_ff"] = 192
    (tmp_path / "bench/configs/qwen3-1.7b-wide.json").write_text(
        json.dumps(conf))
    mix = json.loads((ROOT / "bench/traffic/serve-docs.json").read_text())
    mix["tiny"]["calls"]["lengths"]["median"] = 16
    (tmp_path / "bench/traffic/serve-short.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/calls_per_s.serve.py").write_text(
        "def read(run):\n"
        "    return len(run['fresh_calls']) / run['window_s']\n")
    b["configs"].append({**b["configs"][0], "name": "qwen3-1.7b-wide",
                         "file": "bench/configs/qwen3-1.7b-wide.json"})
    cell = "qwen3-1.7b-wide.serve-short"
    b["workloads"].append({"name": cell, "config": "qwen3-1.7b-wide",
                           "traffic": "serve-short", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "calls_per_s.serve", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving engine",
                           "moves": "serve_tokens_per_s",
                           "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    harness = {p.name: p.read_bytes()
               for p in (ROOT / "bench" / "harness").glob("*.py")}
    bench_run.prepare(ROOT)
    spec = Spec(tmp_path, cell, tiny=True)
    assert spec.config["model"]["d_ff"] == 192
    out, _ = bench_run.run_cell(spec, 2**31 + 9, 0.0, True,
                                torch.device("cpu"))
    assert out["correct"] and out["metrics"]["calls_per_s.serve"]["value"] > 0
    assert {p.name: p.read_bytes()
            for p in (tmp_path / "bench" / "harness").glob("*.py")} == harness


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_model_block_is_the_published_config(name):
    """The ``model`` block a run reads equals what the published
    configuration implies, but for the keys listed in ``reduced`` or
    ``departures``, which differ from it."""
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    conf = json.loads((ROOT / entry["file"]).read_text())
    m = conf["model"]
    pub = families.of(m).published(conf["source_config"])
    assert set(conf["departures"]) <= set(pub)
    assert not set(conf["departures"]) & set(conf["reduced"])
    for k, v in pub.items():
        if k in conf["reduced"] or k in conf["departures"]:
            assert m[k] != v, k
        else:
            assert m[k] == v, (k, m[k], v)
    for k in conf["departures"]:
        assert not WIDTHS.search(k) or k == "ssm_chunk", k


def test_the_harness_names_no_family():
    """Nothing of the harness branches on a family: each family's pieces
    are files of their own, found by name."""
    fams = {p.stem for p in (ROOT / "bench" / "families").glob("*.py")
            if p.stem != "__init__"}
    files = [*(ROOT / "bench" / "harness").glob("*.py"),
             ROOT / "bench" / "run.py", *(ROOT / "bench" / "metrics").glob(
                 "*.py")]
    for path in files:
        text = path.read_text()
        for f in fams:
            assert f'"{f}"' not in text and f"'{f}'" not in text, (path, f)


def test_new_family_from_new_files_alone(tmp_path):
    """A model family added by new files alone: its file under
    ``bench/families``, its reference, a configuration and a cell; the
    tiny cell runs traced and correct from a copy of the benchmark."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    harness = {p.name: p.read_bytes()
               for p in (ROOT / "bench" / "harness").glob("*.py")}
    new = tmp_path / "bench"
    (new / "families" / "gqa.py").write_text(
        (ROOT / "bench/families/dense.py").read_text())
    (new / "reference" / "gqa.py").write_text(
        (ROOT / "bench/reference/dense.py").read_text())
    conf = json.loads((ROOT / "bench/configs/qwen3-1.7b.json").read_text())
    conf["name"] = "qwen3-gqa"
    conf["model"]["family"] = "gqa"
    (new / "configs/qwen3-gqa.json").write_text(json.dumps(conf))
    b = json.loads(json.dumps(BENCH))
    b["configs"].append({**b["configs"][0], "name": "qwen3-gqa",
                         "file": "bench/configs/qwen3-gqa.json"})
    cells = []
    for w in b["workloads"][:1] + b["workloads"][2:3]:
        cells.append(f"qwen3-gqa.{w['traffic']}")
        b["workloads"].append({**w, "name": cells[-1], "config": "qwen3-gqa"})
    for m in b["end_to_end"] + b["per_layer"]:
        for w, c in zip(b["workloads"][:1] + b["workloads"][2:3], cells):
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(c)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys, torch; from pathlib import Path; "
            "from bench import run as R; from bench.harness.cells import Spec; "
            "root = Path.cwd(); R.prepare(root); "
            "import bench.families.gqa as g; "
            "assert Path(g.__file__).resolve().is_relative_to(root); "
            "outs = [R.run_cell(Spec(root, c, tiny=True), 2**31 + 11, 0.0, "
            "True, torch.device('cpu'))[0] for c in sys.argv[1:]]; "
            "print(json.dumps(outs))")
    p = subprocess.run([sys.executable, "-c", code, *cells], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                            "OMP_NUM_THREADS": "1",
                            "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr[-2000:]
    outs = json.loads(p.stdout.strip().splitlines()[-1])
    for out in outs:
        assert out["correct"], out["checks"]
        assert any(k.startswith("mfu.") for k in out["metrics"])
    assert {p.name: p.read_bytes()
            for p in (new / "harness").glob("*.py")} == harness
