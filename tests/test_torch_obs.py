"""The port's NVTrace metrics and spans (``repro_torch.obs.metrics`` and
``.spans``) against the reference's on the CPU: the same seeded samples
and call sequences give equal histograms, quantiles, merges, registry
snapshots (as ``json.dumps(sort_keys=True)`` text), Prometheus text and
span bills; the disabled tracer, the flight-recorder feed, the JSONL
dump and ``FaultsTee`` behave as the reference's; and each package's
``RequestLog`` bills the same persistence instructions to the same
phases over one commit/snapshot sequence.

Clock values (span ``t_us``/``dur_us``, ``restart_timing``, the
``*_us`` histograms a log times) differ between two runs of either
package; every comparison below leaves them out and says so.
"""
import json

import numpy as np
import pytest

from repro.analysis.trace import PersistTrace as JTrace
from repro.obs import metrics as JM
from repro.obs import spans as JS
from repro.obs.timeline import EventTimeline as JTimeline
from repro.persistence.manifest import StagedIO as JIO
from repro.serving.engine import RequestLog as JLog
from repro_torch.analysis.trace import PersistTrace as TTrace
from repro_torch.obs import metrics as TM
from repro_torch.obs import spans as TS
from repro_torch.obs.timeline import EventTimeline as TTimeline
from repro_torch.obs.timeline import FlightRecorder
from repro_torch.persistence.manifest import StagedIO as TIO
from repro_torch.robustness.faultinject import CrashPlan, CrashPoint
from repro_torch.serving.engine import RequestLog as TLog

PKGS = {"jax": (JM, JS, JIO, JLog, JTimeline, JTrace),
        "port": (TM, TS, TIO, TLog, TTimeline, TTrace)}


def _text(snap) -> str:
    return json.dumps(snap, sort_keys=True)


def _samples(seed, n=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(4, 2, n), [0.0, 0.5, 1e9],
                           rng.uniform(1, 1e4, 20)]).tolist()


def _fill(M, seed):
    """One registry filled the same way in either package."""
    reg = M.MetricsRegistry()
    vals = _samples(seed)
    reg.counter("ops_total", layer="log").inc(len(vals))
    reg.counter("ops_total", layer="map").inc(seed)
    reg.gauge("map_load_imbalance", shard=str(seed % 3)).set(seed / 7)
    for phase, growth in (("commit", 1.25), ("snapshot", 2.0)):
        h = reg.histogram("span_us", lo=0.1, hi=1e8, growth=growth,
                          phase=phase)
        for v in vals:
            h.record(v)
    reg.histogram("empty_us", lo=1.0, hi=10.0, growth=2.0)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_and_quantiles_equal_the_references(seed):
    vals = _samples(seed)
    hs = {}
    for name, (M, *_) in PKGS.items():
        h = M.Histogram(lo=0.5, hi=1e6, growth=1.3)
        for v in vals:
            h.record(v)
        hs[name] = h
    j, t = hs["jax"], hs["port"]
    assert t.bounds == j.bounds and t.counts == j.counts
    assert (t.sum, t.min, t.max, t.count) == (j.sum, j.min, j.max, j.count)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert t.quantile(q) == j.quantile(q)


def test_merged_histograms_equal_the_references():
    out = {}
    for name, (M, *_) in PKGS.items():
        parts = []
        for seed in range(3):
            h = M.Histogram(lo=1.0, hi=1e4, growth=1.5)
            for v in _samples(seed, 50):
                h.record(v)
            parts.append(h)
        left = M.Histogram(lo=1.0, hi=1e4, growth=1.5)
        for p in parts:
            left.merge(p)
        right = M.Histogram(lo=1.0, hi=1e4, growth=1.5)
        parts[1].merge(parts[2])
        right.merge(parts[0])
        right.merge(parts[1])
        assert right.counts == left.counts       # associative
        with pytest.raises(ValueError, match="different"):
            left.merge(M.Histogram(lo=1.0, hi=1e4, growth=2.0))
        out[name] = (left.counts, left.sum, left.min, left.max,
                     [left.quantile(q) for q in (0.5, 0.99)])
    assert out["port"] == out["jax"]


def test_registry_snapshots_merges_and_exports_equal_the_references(
        tmp_path):
    texts = {}
    for name, (M, *_) in PKGS.items():
        regs = [_fill(M, seed) for seed in (3, 4, 5)]
        snaps = [json.loads(json.dumps(r.snapshot())) for r in regs]
        merged = M.MetricsRegistry.from_snapshot(snaps[0])
        for s in snaps[1:]:
            merged.merge_snapshot(s)
        other = M.MetricsRegistry()
        for s in reversed(snaps):
            other.merge_snapshot(s)
        assert _text(other.snapshot()["counters"]) == \
            _text(merged.snapshot()["counters"])
        twin = M.MetricsRegistry.from_snapshot(snaps[0])
        assert _text(twin.snapshot()) == _text(regs[0].snapshot())
        regs[0].dump_json(tmp_path / f"{name}.json")
        texts[name] = (_text(regs[0].snapshot()), _text(merged.snapshot()),
                       regs[0].to_prometheus(), merged.to_prometheus(),
                       (tmp_path / f"{name}.json").read_text())
    assert texts["port"] == texts["jax"]
    prom = texts["port"][2]
    assert '# TYPE span_us histogram' in prom
    assert 'span_us_bucket{le="+Inf",phase="commit"} 323' in prom
    assert 'ops_total{layer="log"} 323' in prom


def _span_run(S, IO, M, root):
    """One instruction stream under nested spans, a listener and a
    flight recorder on the tracer's ``on_span`` feed."""
    reg = M.MetricsRegistry()
    tr = S.Tracer(registry=reg)
    fed = []
    tr.on_span = fed.append
    io = IO(root)
    listener = S.PersistListener(tracer=tr, registry=reg).attach(io)
    with tr.span("plan"):
        assert tr.current.phase == "plan"
    with tr.span("commit", n=2):
        io.write("a.tmp", b"x")
        with tr.span("flush_fence"):
            assert tr.current.phase == "flush_fence"
            io.flush("a.tmp")
            io.fence()
        io.publish("a.tmp", "a")
    io.unlink("a")
    assert tr.current is None
    tr.dump_jsonl(root / "spans.jsonl")
    lines = [json.loads(x) for x in
             (root / "spans.jsonl").read_text().splitlines()]
    # t_us and dur_us are clock values: left out
    strip = [{k: v for k, v in r.items() if k not in ("t_us", "dur_us")}
             for r in lines]
    assert strip == [{k: v for k, v in r.items()
                      if k not in ("t_us", "dur_us")} for r in fed]
    return (strip, tr.totals, tr.span_counts, listener.totals,
            sorted((c["name"], c["labels"]["kind"], c["value"])
                   for c in reg.snapshot()["counters"]))


def test_span_bills_feed_and_jsonl_equal_the_references(tmp_path):
    out = {name: _span_run(S, IO, M, tmp_path / name)
           for name, (M, S, IO, *_) in PKGS.items()}
    assert out["port"] == out["jax"]
    recs, totals, span_counts, listener, _ = out["port"]
    assert [r["span"] for r in recs] == ["plan", "flush_fence", "commit"]
    assert recs[2]["counts"] == {"write": 1, "publish": 1}
    assert recs[2]["meta"] == {"n": 2}
    assert totals == listener == {"write": 1, "flush": 1, "fence": 1,
                                  "publish": 1, "trim": 1}
    assert span_counts == {"write": 1, "flush": 1, "fence": 1,
                           "publish": 1}    # the trim ran outside a span


def test_disabled_tracer_is_a_noop_in_both():
    for M, S, *_ in PKGS.values():
        reg = M.MetricsRegistry()
        tr = S.Tracer(registry=reg, enabled=False)
        with tr.span("commit") as s:
            assert s is None
        assert tr.records() == [] and reg.entries() == []
        assert tr.current is None


def test_faults_tee_fans_one_stream_out_in_both(tmp_path):
    """A PersistTrace and a PersistListener behind one FaultsTee see the
    same instruction stream; a firing crash plan behind the tee still
    raises through it."""
    out = {}
    for name, (M, S, IO, _, _, Trace) in PKGS.items():
        reg = M.MetricsRegistry()
        tr = S.Tracer(registry=reg)
        listener = S.PersistListener(tracer=tr, registry=reg)
        trace = Trace()
        io = IO(tmp_path / name)
        tee = S.FaultsTee(trace, listener).attach(io)
        assert io.faults is tee
        with tr.span("workload"):
            for i in range(4):
                io.write(f"f{i}.tmp", b"v")
                io.flush(f"f{i}.tmp")
            io.fence()
            for i in range(4):
                io.publish(f"f{i}.tmp", f"f{i}")
            io.unlink("f0")
        kinds = {}
        for ev in trace.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        assert listener.totals == kinds == tr.totals
        out[name] = (kinds, [s.kind for s in trace.sites])
    assert out["port"] == out["jax"]
    io = TIO(tmp_path / "crash")
    plan = CrashPlan(crash_at=1).attach(io)   # site 1: the fence
    rec = FlightRecorder(capacity=8, clock=lambda: 0.0)
    TS.FaultsTee(rec, plan).attach(io)        # the tee takes the slot
    io.write("a.tmp", b"x")
    io.flush("a.tmp")
    with pytest.raises(CrashPoint):
        io.fence()
    assert [e["kind"] for e in rec.entries()] == ["write", "flush"]


def _log_sequence(Log, M, S, Timeline, root):
    """One commit/snapshot sequence on a fresh log: growth of the dedup
    map past its seed capacity, evictions, two snapshots, a reopen."""
    reg = M.MetricsRegistry()
    tr = S.Tracer(registry=reg)
    tl = Timeline(epoch_ns=0)
    log = Log(root, capacity=16, registry=reg, tracer=tr, timeline=tl,
              device="cpu") if Log is TLog else \
        Log(root, capacity=16, registry=reg, tracer=tr, timeline=tl)
    for i in range(6):
        rids = range(8 * i, 8 * i + 8)
        log.commit({r: [r % 7, 1] for r in rids},
                   evict=log.expired_rids(20))
        if i in (2, 4):
            log.snapshot()
    bills = {}
    for r in tr.records():
        b = bills.setdefault(r["span"], {})
        for k, n in r["counts"].items():
            b[k] = b.get(k, 0) + n
    snap = reg.snapshot()
    # the *_us histograms hold clock values: only their counts compare
    hist = sorted((h["name"], json.dumps(h["labels"], sort_keys=True),
                   sum(h["counts"])) for h in snap["histograms"])
    events = [{k: v for k, v in e.items() if k not in ("t_us", "total_us")}
              for e in tl.to_list()]
    return (bills, tr.totals, _text(snap["counters"]), hist, events,
            log.committed(), sorted(p.name for p in root.iterdir()))


def test_request_logs_bill_the_same_phases(tmp_path):
    out = {name: _log_sequence(Log, M, S, Timeline, tmp_path / name)
           for name, (M, S, _, Log, Timeline, _) in PKGS.items()}
    assert out["port"] == out["jax"]
    bills, _, _, _, events, _, _ = out["port"]
    assert bills["flush_fence"] == {"flush": 8, "fence": 8}
    assert bills["publish"] == {"publish": 2}
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "log_open" and "dedup_migration" in kinds
    assert kinds.count("snapshot") == kinds.count("truncate") == 2


def test_request_log_without_obs_has_no_listener_in_both(tmp_path):
    for name, (M, _, _, Log, *_) in PKGS.items():
        reg = M.MetricsRegistry()
        kw = {"device": "cpu"} if Log is TLog else {}
        log = Log(tmp_path / name, capacity=16, registry=reg, obs=False,
                  **kw)
        assert log.io.faults is None and not log.tracer.enabled
        log.commit({1: [1]})
        log.snapshot()
        assert log.tracer.records() == []
        assert not any(c["name"] == "persist_events_total"
                       for c in reg.snapshot()["counters"])
        assert reg.counter("serving_commits_total").value == 1
