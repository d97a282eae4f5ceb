"""The port's LoadScope layer (``repro_torch.obs.windows``, ``.timeline``
and ``.loadgen``) against the reference's on the CPU.

Pure host code compares exactly: windowed series and snapshots,
excursion attribution, flight-recorder dumps, schedules and their
fingerprints, validation errors.  The harness runs once in each package
(the port on ``device="cpu"``) on the same spec: fingerprints, counters,
the sequence of timeline kinds, the acked rids and their ``took_effect``
answers after a reopen, the crash report and the log directories' bytes
are equal.  Latencies, ``t_us`` stamps and ``restart_timing``'s times are
host-clock values and differ between any two runs; no file in a log
directory holds one.  ``compile_stall`` annotations record each
package's own first-call stalls (JAX compiles against the port's first
launches) and stay out of the comparison.
"""
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

from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import tiny as jtiny
from repro.models.model import build_model
from repro.obs import loadgen as JL
from repro.obs import timeline as JT
from repro.obs import windows as JW
from repro.serving.engine import RequestLog as JLog
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.configs.registry import get_arch, tiny
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.obs import loadgen as TL
from repro_torch.obs import timeline as TT
from repro_torch.obs import windows as TW
from repro_torch.serving.engine import RequestLog as TLog
from repro_torch.serving.engine import ServeEngine as TEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PKGS = {"jax": (JW, JT, JL), "port": (TW, TT, TL)}


def _samples(seed, n=200, t_hi=1000.0):
    rng = np.random.default_rng(seed)
    return list(zip(rng.lognormal(3, 1.5, n).tolist(),
                    rng.uniform(0, t_hi, n).tolist()))


# --------------------------------------------------------------------- #
# windows                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_series_and_snapshots_equal_the_references(seed):
    out = {}
    for name, (W, _, _) in PKGS.items():
        w = W.WindowedHistogram(window_us=37.5, lo=1.0, hi=1e4, growth=1.5,
                                max_windows=16)
        c = W.WindowedCounter(window_us=37.5, max_windows=16)
        for v, t in _samples(seed):
            w.record(v, t_us=t)
            c.inc(int(v) % 5, t_us=t)
        assert w.dropped_epochs > 0 and c.dropped_epochs > 0
        out[name] = (json.dumps(w.series(quantiles=(0.5, 0.9, 0.99))),
                     json.dumps(w.snapshot(), sort_keys=True),
                     json.dumps(c.series()),
                     json.dumps(c.snapshot(), sort_keys=True),
                     w.merged().counts, w.lifetime.counts)
    assert out["port"] == out["jax"]


def test_windowed_merges_are_associative_and_cross_the_packages():
    def mk(W, seed):
        w = W.WindowedHistogram(window_us=25.0, lo=1.0, hi=1e4, growth=1.5)
        for v, t in _samples(seed, 60, 200.0):
            w.record(v, t_us=t)
        return json.loads(json.dumps(w.snapshot()))

    for W, _, _ in PKGS.values():
        snaps = [mk(W, s) for s in (1, 2, 3)]
        rows = []
        for order in ((0, 1, 2), (2, 1, 0), (1, 0, 2), (2, 0, 1)):
            m = W.WindowedHistogram(window_us=25.0, lo=1.0, hi=1e4,
                                    growth=1.5)
            for i in order:
                m.merge_snapshot(snaps[i])
            rows.append(json.dumps(m.series()))
        assert len(set(rows)) == 1
        with pytest.raises(ValueError, match="window/bucket layouts"):
            m.merge_snapshot(W.WindowedHistogram(window_us=7.0).snapshot())
    # a snapshot from either package merges into the other
    j = JW.WindowedHistogram.from_snapshot(mk(TW, 4))
    t = TW.WindowedHistogram.from_snapshot(mk(JW, 4))
    assert json.dumps(j.series()) == json.dumps(t.series())


_CHILD = """
import json, sys
import numpy as np
from repro_torch.obs.windows import WindowedHistogram
seed = int(sys.argv[1])
w = WindowedHistogram(window_us=40.0, lo=1.0, hi=1e4, growth=1.5)
rng = np.random.default_rng(seed)
for t, v in zip(rng.uniform(0, 400, 80), rng.uniform(1, 9e3, 80)):
    w.record(float(v), t_us=float(t))
print(json.dumps(w.snapshot()))
"""


def test_snapshot_merge_across_port_subprocesses():
    """Two port-only subprocesses (no JAX imported) each record a shard
    and print its snapshot; merged in either order they equal one
    process recording everything, in the port and in the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    snaps = [json.loads(subprocess.run(
        [sys.executable, "-c", _CHILD, str(seed)], capture_output=True,
        text=True, env=env, check=True, timeout=120).stdout)
        for seed in (101, 202)]
    for W, _, _ in PKGS.values():
        local = W.WindowedHistogram(window_us=40.0, lo=1.0, hi=1e4,
                                    growth=1.5)
        for seed in (101, 202):
            rng = np.random.default_rng(seed)
            for t, v in zip(rng.uniform(0, 400, 80),
                            rng.uniform(1, 9e3, 80)):
                local.record(float(v), t_us=float(t))
        for order in ((0, 1), (1, 0)):
            m = W.WindowedHistogram(window_us=40.0, lo=1.0, hi=1e4,
                                    growth=1.5)
            for i in order:
                m.merge_snapshot(snaps[i])
            assert [r["count"] for r in m.series()] == \
                [r["count"] for r in local.series()]
            assert m.lifetime.counts == local.lifetime.counts
            assert m.merged().quantile(0.99) == local.merged().quantile(0.99)


# --------------------------------------------------------------------- #
# timeline, excursions, flight recorder                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_attribute_excursions_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    series = [{"epoch": e, "t_start_us": 100.0 * e,
               "t_end_us": 100.0 * (e + 1), "count": int(c),
               "p99_us": float(p) if c else float("nan")}
              for e, (c, p) in enumerate(zip(
                  rng.integers(0, 6, 40), rng.lognormal(3, 1, 40)))]
    kinds = ("snapshot", "truncate", "dedup_migration", "crash")
    events = [(float(t), kinds[int(k)]) for t, k in zip(
        rng.uniform(0, 4000, 25), rng.integers(0, 4, 25))]
    out = {}
    for name, (_, T, _) in PKGS.items():
        tl = T.EventTimeline(epoch_ns=0)
        for t, k in events:
            tl.annotate(k, t_us=t, i=int(t))
        out[name] = [json.dumps(T.attribute_excursions(
            series, tl, factor=f, slack_us=s, min_count=m), sort_keys=True)
            for f in (1.5, 2.0, 3.0) for s in (0.0, 25.0) for m in (1, 3)]
    assert out["port"] == out["jax"]
    assert any(json.loads(x) for x in out["port"])


def test_flight_recorder_ring_and_dump_equal_the_references(tmp_path):
    out = {}
    for name, (_, T, _) in PKGS.items():
        fr = T.FlightRecorder(capacity=5, clock=lambda: 42.0)
        tl = T.EventTimeline(epoch_ns=0, recorder=fr)
        for i in range(9):
            tl.annotate("snapshot", t_us=float(i), horizon=i)
        fr.on_span({"span": "commit", "t_us": 3.0, "dur_us": 1.0,
                    "counts": {"fence": 1}, "depth": 0})
        fr.on_event("flush", target="log_00000001.json")
        fr.on_site("flush", "x")
        assert len(fr.entries()) == 5 and fr.seen == 11
        d = fr.dump("injected_crash", path=tmp_path / f"{name}.json",
                    restart_timing={"total_us": 5.0},
                    extra={"no_acked_lost": True})
        out[name] = (json.dumps(d, sort_keys=True),
                     (tmp_path / f"{name}.json").read_text(), fr.dumps)
        with pytest.raises(ValueError, match="capacity"):
            T.FlightRecorder(capacity=0)
    assert out["port"] == out["jax"]
    d = json.loads(out["port"][0])
    assert set(d) == {"reason", "t_us", "capacity", "n_entries", "seen",
                      "dropped", "entries", "restart_timing",
                      "no_acked_lost"}
    assert [e["type"] for e in d["entries"]] == \
        ["annotation"] * 3 + ["span", "persist"]


# --------------------------------------------------------------------- #
# schedules                                                              #
# --------------------------------------------------------------------- #
def test_load_spec_is_the_references_field_for_field():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JL.LoadSpec)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(TL.LoadSpec)]
    assert tf == jf
    assert TL.LoadSpec.__dataclass_params__.frozen


@pytest.mark.parametrize("mode", ["closed", "open"])
@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_schedules_equal_the_references(mode, dist, seed):
    kw = dict(n_ops=500, seed=seed, mode=mode, dist=dist, skew=1.3,
              rate_ops_s=750.0, retain=64, update_frac=0.55)
    j = JL.make_schedule(JL.LoadSpec(**kw))
    t = TL.make_schedule(TL.LoadSpec(**kw))
    for f in ("is_update", "rank", "arrival_us"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.fingerprint() == j.fingerprint()
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)


@pytest.mark.parametrize("bad", [
    dict(mode="ajar"), dict(dist="pareto"), dict(dist="zipf", skew=1.0),
    dict(mode="open", rate_ops_s=0.0)])
def test_schedule_validation_errors_are_the_references(bad):
    msgs = []
    for L in (JL, TL):
        with pytest.raises(ValueError) as e:
            L.make_schedule(L.LoadSpec(**bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------- #
# the harness, run by both packages                                      #
# --------------------------------------------------------------------- #
CLOSED = dict(n_ops=24, seed=9, dist="zipf", skew=1.4, update_frac=0.6,
              batch=3, window_us=5_000.0, retain=32, snapshot_every=4,
              warmup_ops=2, capacity=16)
CRASH = dict(n_ops=16, seed=2, dist="uniform", update_frac=0.7, batch=2,
             window_us=20_000.0, retain=16, snapshot_every=None,
             warmup_ops=2, crash_at_op=8, crash_evict="torn", capacity=16)


def _run(name, spec_kw, root):
    L = PKGS[name][2]
    kw = {"device": "cpu"} if name == "port" else {}
    return L.LoadHarness(str(root / "log"), L.LoadSpec(**spec_kw),
                         flight_path=str(root / "flight.json"), **kw).run()


def _dir_bytes(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture(scope="module", params=["closed", "crash"])
def harness(request, tmp_path_factory):
    spec_kw = CLOSED if request.param == "closed" else CRASH
    out = {}
    for name in PKGS:
        root = tmp_path_factory.mktemp(f"{request.param}_{name}")
        out[name] = (_run(name, spec_kw, root), root)
    return request.param, spec_kw, out


def _kinds(rep):
    return [e["kind"] for e in rep["timeline"] if e["kind"] != "compile_stall"]


def test_harness_reports_agree(harness):
    point, spec_kw, out = harness
    (j, _), (t, _) = out["jax"], out["port"]
    assert t["schedule_fingerprint"] == j["schedule_fingerprint"] == \
        TL.make_schedule(TL.LoadSpec(**spec_kw)).fingerprint()
    assert t["spec"] == j["spec"]
    assert t["counters"] == j["counters"]
    assert _kinds(t) == _kinds(j)
    assert sum(r["count"] for r in t["series"]) == spec_kw["n_ops"]
    assert t["p99_us"] >= t["p50_us"] > 0
    for k in ("target", "ops", "rids_processed"):
        assert t[k] == j[k]
    assert t["flight"]["dumps"] == j["flight"]["dumps"]
    assert "log_open" in _kinds(t)
    if point == "closed":
        assert {"snapshot", "truncate", "dedup_migration"} <= set(_kinds(t))


def test_harness_acks_and_took_effect_agree(harness):
    """Reopened after the run, both logs answer took_effect alike for
    every rid the run could have touched, and every acked rid of the
    retain window took effect."""
    _, spec_kw, out = harness
    acked = chip_smoke.acked_rids(TL.LoadSpec(**spec_kw))
    probe = list(range(len(acked) + 8))
    got = {}
    for name, (_, root) in out.items():
        log = TLog(root / "log", device="cpu") if name == "port" else \
            JLog(root / "log")
        got[name] = np.asarray(log.took_effect(probe))
        got[name + "_committed"] = log.committed()
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert got["port_committed"] == got["jax_committed"]
    assert got["port"][acked[-spec_kw["retain"]:]].all()
    assert not got["port"][len(acked):].any()


def test_harness_log_directories_are_byte_identical(harness):
    _, _, out = harness
    d = {name: _dir_bytes(root / "log") for name, (_, root) in out.items()}
    assert list(d["port"]) == list(d["jax"])
    assert d["port"] == d["jax"]


def test_crash_reports_agree(harness):
    point, _, out = harness
    if point != "crash":
        assert "crash" not in out["port"][0] and "crash" not in out["jax"][0]
        return
    (j, jroot), (t, troot) = out["jax"], out["port"]
    for rep in (j, t):
        assert rep["crash"]["no_acked_lost"] is True
        assert rep["crash"]["evict"] == "torn"
    assert set(t["crash"]["restart_timing"]) == \
        set(j["crash"]["restart_timing"])
    assert t["crash"]["restart_timing"]["records_parsed"] == \
        j["crash"]["restart_timing"]["records_parsed"]
    assert set(t["crash"]["flight_dump"]) == set(j["crash"]["flight_dump"])
    kinds = []
    for root in (jroot, troot):
        dump = json.loads((root / "flight.json").read_text())
        assert dump["reason"] == "injected_crash"
        assert {"span", "persist"} <= {e["type"] for e in dump["entries"]}
        kinds.append([(e["type"], e.get("kind", e.get("span")))
                      for e in dump["entries"]
                      if e.get("kind") != "compile_stall"])
    assert kinds[0] == kinds[1]


def test_harness_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.LoadHarness(str(tmp_path), TL.LoadSpec())


# --------------------------------------------------------------------- #
# the engine point                                                       #
# --------------------------------------------------------------------- #
ENGINE = dict(n_ops=12, seed=29, dist="zipf", skew=1.3, update_frac=0.5,
              batch=2, window_us=100_000.0, retain=64, snapshot_every=None,
              warmup_ops=2)


def test_engine_points_commit_identical_tokens(tmp_path):
    """benchmarks/loadtest.py's engine point on tiny(qwen2-7b), the JAX
    init carried across: both packages' harnesses commit the same greedy
    tokens for every rid, with the same counters."""
    jcfg, cfg = jtiny(jget_arch("qwen2-7b")), tiny(get_arch("qwen2-7b"))
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    kw = dict(max_len=24, batch_size=2, retain=64, snapshot_every=10)
    factories = {
        "jax": lambda registry, timeline: JEngine(
            jm, jp, log_dir=str(tmp_path / "jax"), registry=registry,
            timeline=timeline, **kw),
        "port": lambda registry, timeline: TEngine(
            tm, tp, log_dir=str(tmp_path / "port"), registry=registry,
            timeline=timeline, device="cpu", **kw)}
    reps, committed = {}, {}
    for name, (_, _, L) in PKGS.items():
        reps[name] = L.LoadHarness(str(tmp_path / f"{name}_h"),
                                   L.LoadSpec(**ENGINE),
                                   engine=factories[name]).run()
        log = JLog(tmp_path / "jax") if name == "jax" else \
            TLog(tmp_path / "port", device="cpu")
        committed[name] = log.committed()
    assert committed["port"] == committed["jax"]
    n_commits = max(1, ENGINE["warmup_ops"]) + int(
        TL.make_schedule(TL.LoadSpec(**ENGINE)).is_update.sum())
    assert sorted(committed["port"]) == list(range(2 * n_commits))
    assert reps["port"]["counters"] == reps["jax"]["counters"]
    assert reps["port"]["target"] == "engine"
    assert _kinds(reps["port"]) == _kinds(reps["jax"])


def test_load_phase_runs_on_the_cpu():
    """chip_smoke.py's load phase at small size: every point's checks
    pass (fingerprints, window counts, p50 <= p99, the retain window
    after a reopen, the crash and its dump, reads without a prefill)."""
    out = chip_smoke.run_load(chip_smoke.SMALL, torch.device("cpu"), 1)
    pts = out["points"]
    assert set(pts) == {"closed_zipf1.1", "closed_zipf1.5", "closed_uniform",
                        "open_zipf1.3", "closed_crash",
                        "closed_zipf1.3_shards4", "engine_closed_zipf1.3"}
    assert pts["closed_crash"]["crash"]["no_acked_lost"] is True
    assert pts["closed_zipf1.1"]["dedup_migrations"] >= 1
    eng = pts["engine_closed_zipf1.3"]
    assert eng["reads"] > 0 and eng["updates"] > 0
    assert out["any_attributed"] == (out["n_attributed_total"] >= 1)
