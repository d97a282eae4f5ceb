"""Each cell of the benchmark run on the CPU at its ``tiny`` form, through
the same harness as on the card: the result line's schema, the metrics
each cell reports, and a correct comparison; and the traffic
generator's promises (same seed, same inputs; another seed, the same
work in another order)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import run as bench_run
from bench.harness import traffic
from bench.harness.cells import Spec

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 17          # past 32 signed bits, as the driver's are
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_run(workload: str, trace: bool, root: Path = ROOT,
             seed: int = SEED) -> dict:
    bench_run.prepare(root)
    out, _ = bench_run.run_cell(Spec(root, workload, tiny=True), seed, 0.0,
                                trace, torch.device("cpu"))
    return out


@pytest.mark.parametrize("workload,trace", [
    (CELLS[0], False), (CELLS[1], True), (CELLS[2], True),
    (CELLS[0], True), (CELLS[1], False), (CELLS[2], False)])
def test_cell_runs_at_its_tiny_form(workload, trace):
    spec = Spec(ROOT, workload, tiny=True)
    out = tiny_run(workload, trace)
    assert out["correct"] is True, out["checks"]
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in out) == trace
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    wanted = {e["name"]: e["unit"] for e in spec.metrics(trace)}
    assert set(out["metrics"]) <= set(wanted)
    for name, m in out["metrics"].items():
        assert m["unit"] == wanted[name] and np.isfinite(m["value"])
    if not trace:       # every end-to-end metric is read in every run
        assert set(out["metrics"]) == set(wanted)
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_train_feed_is_the_seeds_and_fresh_each_step():
    a = traffic.train_rows(SEED, 0, 4, 16, 512)
    assert np.array_equal(a, traffic.train_rows(SEED, 0, 4, 16, 512))
    assert not np.array_equal(a, traffic.train_rows(SEED, 1, 4, 16, 512))
    assert not np.array_equal(a, traffic.train_rows(SEED + 1, 0, 4, 16, 512))
    assert len({r.tobytes() for r in a}) == 4


SERVE = [c for c in CELLS if Spec(ROOT, c).kind == "serve"]


def test_serve_calls_same_work_in_another_order(tiny=False):
    calls = Spec(ROOT, SERVE[0], tiny=tiny).traffic["calls"]
    lens = traffic.call_lengths(calls)

    def run(seed, n=3):
        sc = traffic.ServeCalls(seed, calls, 1000)
        return [sc.next_call() for _ in range(n)]
    a, b = run(SEED), run(SEED + 1)
    assert [sorted(c.requests()) for c in a] == \
        [sorted(c.requests()) for c in run(SEED)]
    assert all(np.array_equal(x.fresh[r], y.fresh[r])
               for x, y in zip(a, run(SEED)) for r in x.fresh)
    for c, d in zip(a, b):       # each call the same lengths, mixed
        assert sorted(map(len, c.fresh.values())) == sorted(lens) == \
            sorted(map(len, d.fresh.values()))
        assert len(set(map(len, c.fresh.values()))) > 1
    assert [len(p) for c in a for p in c.fresh.values()] != \
        [len(p) for c in b for p in c.fresh.values()]
    fresh = [r for c in a for r in c.fresh]
    assert len(set(fresh)) == len(fresh) == 3 * len(lens)
    assert not a[0].resent
    for prev, c in zip(a, a[1:]):   # re-sends: the call before's requests
        assert len(c.resent) == calls["resend_per_call"]
        assert all(np.array_equal(p, prev.fresh[r])
                   for r, p in c.resent.items())


def test_serve_calls_at_the_tiny_form():
    test_serve_calls_same_work_in_another_order(tiny=True)


def test_call_lengths_follow_the_mix():
    """The full mix: a log-normal's quantiles cut to whole blocks, its
    median kept to a block, the longest prompt at the cut."""
    calls = Spec(ROOT, SERVE[0]).traffic["calls"]
    L, lens = calls["lengths"], traffic.call_lengths(calls)
    assert len(lens) == calls["requests_per_call"]
    assert all(x % L["block"] == 0 and L["block"] <= x <= L["max"]
               for x in lens)
    assert abs(float(np.median(lens)) - L["median"]) <= L["block"]
    assert max(lens) == L["max"] and lens == sorted(lens)
