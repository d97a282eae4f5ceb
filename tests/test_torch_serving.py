"""The port's RequestLog: the reference's RequestLog cases
(tests/test_serving.py) run against the port on the CPU, plus
cross-package restart parity -- a log directory written by either package
reopens in the other with identical committed results, dedup answers and
dedup-map arrays, and the same commits write the same bytes."""
import time as _time
from pathlib import Path

import numpy as np
import pytest

from repro.serving.engine import RequestLog as JaxLog
from repro_torch.serving import engine as eng_mod
from repro_torch.serving.engine import RequestLog


def Log(root, **kw):
    return RequestLog(root, device="cpu", **kw)


def test_request_log_dedup_oob_rids_and_cross_instance(tmp_path):
    log = Log(tmp_path)
    log.commit({7: [1], 2**33: [2], -5: [3]})
    assert list(log.is_committed([7, 2**33, -5, 8])) == [True] * 3 + [False]
    log2 = Log(tmp_path)
    assert list(log2.is_committed([7, 2**33, -5, 8])) == [True] * 3 + [False]
    a, b = Log(tmp_path), Log(tmp_path)
    b.commit({42: [9]})
    a.refresh()
    assert bool(a.is_committed([42])[0])


def test_request_log_torn_record_never_causes_overwrite(tmp_path):
    log = Log(tmp_path)
    log.commit({1: [1]})
    log.commit({2: [2]})
    log.commit({3: [3]})
    (tmp_path / "log_000001.json").write_text('{"2": [2')
    log2 = Log(tmp_path)
    assert log2._n == 3
    assert not (tmp_path / "log_000001.json").exists()
    log2.commit({4: [4]})
    got = log2.committed()
    assert got[1] == [1] and got[3] == [3] and got[4] == [4]
    assert list(log2.is_committed([1, 3, 4])) == [True] * 3
    assert (tmp_path / "log_000003.json").exists()


def test_request_log_concurrent_instances_never_collide(tmp_path):
    a, b = Log(tmp_path), Log(tmp_path)
    a.commit({1: [1]})
    b.commit({2: [2]})
    assert Log(tmp_path).committed() == {1: [1], 2: [2]}


def test_request_log_torn_record_heals_when_writer_completes(tmp_path):
    log = Log(tmp_path)
    p = tmp_path / "log_000000.json"
    p.write_text('{"9": [1')
    log.refresh()
    assert not log.is_committed([9])[0]
    assert "log_000000.json" in log._torn
    p.write_text('{"9": [1, 2]}')
    log.refresh()
    assert bool(log.is_committed([9])[0])
    assert "log_000000.json" not in log._torn


def test_request_log_crash_between_claim_and_fence(tmp_path):
    log = Log(tmp_path)
    log._claim_slot()
    log.io.crash(evict="none")
    log2 = Log(tmp_path)
    assert not (tmp_path / "log_000000.json").exists()
    log2.commit({5: [5]})
    assert (tmp_path / "log_000001.json").exists()
    assert log2.committed() == {5: [5]}
    assert bool(log2.is_committed([5])[0])


def test_refresh_skips_scan_when_dir_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(RequestLog, "_RACY_NS", 50_000_000)
    log = Log(tmp_path)
    log.commit({1: [1]})
    _time.sleep(RequestLog._RACY_NS / 1e9 + 0.02)
    log.refresh()
    other = Log(tmp_path)
    calls = []
    orig = RequestLog._scan

    def counting_scan(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(RequestLog, "_scan", counting_scan)
    log.refresh()
    log.refresh()
    assert calls == []
    other.commit({2: [2]})
    log.refresh()
    assert calls == [1]
    assert bool(log.is_committed([2])[0])


def test_refresh_torn_record_checks_only_torn_not_full_scan(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(RequestLog, "_RACY_NS", 50_000_000)
    log = Log(tmp_path)
    log.commit({1: [1]})
    p = tmp_path / "log_000001.json"
    p.write_text('{"9": [1')
    _time.sleep(RequestLog._RACY_NS / 1e9 + 0.02)
    log.refresh()
    assert "log_000001.json" in log._torn
    scans = []
    monkeypatch.setattr(RequestLog, "_scan", lambda self: scans.append(1))
    log.refresh()
    assert scans == []
    assert not log.is_committed([9])[0]
    p.write_text('{"9": [1, 2]}')
    log.refresh()
    assert scans == []
    assert bool(log.is_committed([9])[0])
    assert "log_000001.json" not in log._torn


def test_request_log_evict_round_and_restart_replay(tmp_path):
    log = Log(tmp_path)
    log.commit({1: [1], 2: [2]})
    log.commit({3: [3]}, evict=[1])
    assert list(log.is_committed([1, 2, 3])) == [False, True, True]
    assert set(log.committed()) == {2, 3}
    log2 = Log(tmp_path)
    assert list(log2.is_committed([1, 2, 3])) == [False, True, True]
    log2.commit({1: [9]})
    assert bool(log2.is_committed([1])[0])
    assert log2.committed()[1] == [9]


def test_request_log_dedup_grows_under_live_traffic(tmp_path):
    log = Log(tmp_path, capacity=16)
    rid = 0
    for _ in range(20):
        log.commit({rid + i: [rid + i] for i in range(16)})
        rid += 16
    assert log.dedup_migrations >= 1
    assert bool(log.is_committed(range(rid)).all())
    assert not log.is_committed([rid, rid + 1]).any()
    log.commit({rid: [1]}, evict=list(range(100)))
    got = log.is_committed(list(range(104)) + [rid])
    assert not got[:100].any() and got[100:].all()
    log2 = Log(tmp_path, capacity=16)
    np.testing.assert_array_equal(
        log2.is_committed(list(range(104)) + [rid]), got)


def test_snapshot_restart_replays_only_the_suffix(tmp_path):
    log = Log(tmp_path)
    for i in range(10):
        log.commit({i: [i, i]})
    assert log.snapshot() == "snap_00000010.json"
    assert sorted(p.name for p in tmp_path.glob("log_*.json")) == []
    log.commit({10: [10, 10]})
    log2 = Log(tmp_path)
    assert log2.records_parsed == 1
    assert log2.committed() == {i: [i, i] for i in range(11)}
    assert log2.snapshot() == "snap_00000011.json"
    assert sorted(p.name for p in tmp_path.glob("snap_*.json")) == \
        ["snap_00000011.json"]
    log3 = Log(tmp_path)
    assert log3.records_parsed == 0
    assert log3.committed() == log2.committed()


def test_snapshot_evictions_torn_horizon_and_interrupted_truncation(
        tmp_path):
    a = tmp_path / "a"
    log = Log(a)
    log.commit({1: [1], 2: [2]})
    log.commit({3: [3]}, evict=[1])
    assert log.snapshot() is not None
    assert log.snapshot() is None
    assert list(Log(a).is_committed([1, 2, 3])) == [False, True, True]
    b = tmp_path / "b"
    log = Log(b)
    for i in range(3):
        log.commit({i: [i]})
    p = b / "log_000003.json"
    p.write_text('{"9": [9')
    assert log.snapshot() == "snap_00000003.json"
    assert p.exists()
    p.write_text('{"9": [9]}')
    assert Log(b).committed() == {0: [0], 1: [1], 2: [2], 9: [9]}
    c = tmp_path / "c"
    log = Log(c)
    log.commit({1: [1]})
    old = log.snapshot(truncate=False)
    log.commit({2: [2]})
    new = log.snapshot(truncate=False)
    assert sorted(p.name for p in c.glob("*.json")) == \
        ["log_000000.json", "log_000001.json", old, new]
    log2 = Log(c)
    assert log2.records_parsed == 0
    assert log2.committed() == {1: [1], 2: [2]}
    assert sorted(p.name for p in c.glob("*.json")) == [new]


def test_took_effect_and_descriptor_without_replay(tmp_path):
    log = Log(tmp_path)
    log.commit({1: [1, 2], 2: [2, 3]})
    log.commit({3: [3, 4]}, evict=[1])
    log.snapshot()
    log2 = Log(tmp_path)
    assert log2.records_parsed == 0
    np.testing.assert_array_equal(log2.took_effect([1, 2, 3, 4]),
                                  [False, True, True, False])
    assert log2.descriptor(2) == {"rid": 2, "took_effect": True,
                                  "result": [2, 3]}
    assert log2.descriptor(1) == {"rid": 1, "took_effect": False,
                                  "result": None}


def test_restart_trim_retries_and_heals(tmp_path, monkeypatch):
    monkeypatch.setattr(RequestLog, "_TRIM_BACKOFF_S", 0.0)
    (tmp_path / "log_000000.json").write_text('{"1": [1')
    orig, calls = Path.unlink, []

    def flaky(self, missing_ok=False):
        if self.name == "log_000000.json":
            calls.append(1)
            if len(calls) == 1:
                raise OSError("EBUSY")
        return orig(self, missing_ok=missing_ok)

    monkeypatch.setattr(Path, "unlink", flaky)
    Log(tmp_path)
    assert calls == [1, 1]
    assert not (tmp_path / "log_000000.json").exists()
    monkeypatch.setattr(Path, "unlink", orig)
    p = tmp_path / "log_000001.json"
    p.write_text('{"7": [7')

    def writer_lands(_secs):
        p.write_text('{"7": [7, 8]}')

    monkeypatch.setattr(eng_mod.time, "sleep", writer_lands)
    log = Log(tmp_path)
    assert p.exists()
    assert log.committed() == {7: [7, 8]}
    assert bool(log.took_effect([7])[0])


@pytest.mark.parametrize("kw", [{"shards": 2}, {"rebalance": True}])
def test_unported_backends_raise(tmp_path, kw):
    """The backends once unported now open: the same history on a sharded
    (or, with ``rebalance`` alone, the reference's single-device) dedup
    map commits, evicts and reopens with the JAX log's answers."""
    n = _history(Log(tmp_path / "port", capacity=16, **kw))
    _history(JaxLog(tmp_path / "jax", capacity=16))
    jl = JaxLog(tmp_path / "jax", capacity=16)
    tl = Log(tmp_path / "port", capacity=16, **kw)
    assert jl.committed() == tl.committed()
    rids = list(range(-2, n + 3)) + [2**33]
    np.testing.assert_array_equal(jl.is_committed(rids),
                                  tl.is_committed(rids))
    assert tl.dedup_migrations >= 1 and tl.dedup_rebalances == 0


def _history(log):
    """One seeded history: growth past the seed pool, evictions, a
    snapshot with truncation, then a post-snapshot suffix."""
    rid = 0
    for i in range(6):
        log.commit({rid + j: [rid + j, i] for j in range(12)},
                   evict=log.expired_rids(30))
        rid += 12
    log.snapshot()
    log.commit({rid: [rid]}, evict=[0, 1, 40])
    return rid + 1


def _assert_logs_same(jl, tl, n):
    assert jl.committed() == tl.committed()
    rids = list(range(-2, n + 3)) + [2**33]
    np.testing.assert_array_equal(jl.is_committed(rids),
                                  tl.is_committed(rids))
    for f in jl._dedup.state._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jl._dedup.state, f)),
            getattr(tl._dedup.state, f).numpy(), err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_log_dirs_reopen_across_packages(tmp_path, writer):
    make = (lambda: JaxLog(tmp_path, capacity=16)) if writer == "jax" \
        else (lambda: Log(tmp_path, capacity=16))
    n = _history(make())
    jl, tl = JaxLog(tmp_path, capacity=16), Log(tmp_path, capacity=16)
    assert jl.records_parsed == tl.records_parsed == 1
    _assert_logs_same(jl, tl, n)
    assert tl.dedup_migrations == jl.dedup_migrations >= 1


def test_same_commits_write_the_same_bytes(tmp_path):
    ja, tb = tmp_path / "jax", tmp_path / "port"
    _history(JaxLog(ja, capacity=16))
    _history(Log(tb, capacity=16))
    names = sorted(p.name for p in ja.iterdir() if p.name != ".clock")
    assert names == sorted(p.name for p in tb.iterdir()
                           if p.name != ".clock")
    for name in names:
        assert (ja / name).read_bytes() == (tb / name).read_bytes(), name


@pytest.mark.parametrize("evict", ["none", "all", "random", "torn"])
def test_staged_io_crash_images_match_jax(tmp_path, evict):
    """Same seed, same writes, same crash: the port's StagedIO leaves the
    reference's files on disk, byte for byte (torn images included)."""
    from repro.persistence.manifest import StagedIO as JaxIO
    from repro.persistence.manifest import digest as jax_digest
    from repro_torch.persistence.manifest import StagedIO, digest
    images = []
    for cls, sub in ((JaxIO, "jax"), (StagedIO, "port")):
        io = cls(tmp_path / sub, seed=7)
        io.write("a.json", b'{"a": 1}')
        io.flush("a.json")
        io.fence()
        for i in range(6):
            io.write(f"staged_{i}.bin", bytes(range(i * 7, i * 7 + 40)))
        io.flush("staged_0.bin")
        io.crash(evict=evict)
        images.append({p.name: p.read_bytes()
                       for p in sorted((tmp_path / sub).iterdir())})
        assert io.counters.snapshot()["fences"] == 1
    assert images[0] == images[1]
    assert digest(b"xyz") == jax_digest(b"xyz")


def test_spans_and_counters_match_jax(tmp_path):
    """The same history bills the same persistence instructions to the
    same spans in both packages, and moves the same registry counters
    (the process-wide first-call and garbage-collector counters aside);
    every flush and fence falls inside a flush_fence span."""
    from repro.obs.metrics import get_registry as jax_registry
    from repro_torch.obs.metrics import get_registry
    seen = []
    for make, reg in ((JaxLog, jax_registry()), (Log, get_registry())):
        reg.reset()
        log = make(tmp_path / reg.__module__, capacity=16)
        _history(log)
        spans = [(r["span"], r["depth"], r["counts"], r.get("meta"))
                 for r in log.tracer.records()]
        counters = {(e.name, tuple(sorted(e.labels.items()))): e.obj.value
                    for e in reg.entries() if e.kind == "counter"
                    and not e.name.startswith(("compile_", "gc_"))}
        seen.append((spans, log.tracer.totals, counters))
        io = log.io.counters
        assert (log.tracer.totals["flush"], log.tracer.totals["fence"]) == \
            (io.flushes, io.fences)
        for phase, _, counts, _ in spans:
            assert phase == "flush_fence" or not {"flush", "fence"} & set(
                counts)
    assert seen[0] == seen[1]


# --------------------------------------------------------------------- #
# ordered_dedup: the dedup set on the ordered map                        #
# --------------------------------------------------------------------- #
def _ordered_history(log, n_batches=8, retain=7):
    """Commits with ordered-by-rid evictions (growth past the seed pool
    included), a snapshot halfway, then a post-snapshot suffix.  Returns
    the expired-rid lists the log answered."""
    answered, rid = [], 0
    for b in range(n_batches):
        ev = log.expired_rids(retain)
        answered.append(ev)
        log.commit({rid + i: [b, i] for i in range(3)}, evict=ev)
        rid += 3
        if b == n_batches // 2:
            log.snapshot()
    return answered


def _assert_ordered_logs_same(jl, tl, n=30):
    assert tl.committed() == jl.committed()
    rids = list(range(-2, n)) + [2**33]
    np.testing.assert_array_equal(tl.took_effect(rids),
                                  jl.took_effect(rids))
    for r in (0, 2, 5, 100):
        assert tl.expired_rids(r) == jl.expired_rids(r)
    assert tl.dedup_migrations == jl.dedup_migrations
    for f in jl._dedup.state._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jl._dedup.state, f)),
            getattr(tl._dedup.state, f).numpy(), err_msg=f)


def test_ordered_dedup_log_matches_jax(tmp_path):
    jl = JaxLog(tmp_path / "jax", capacity=8, ordered_dedup=True)
    tl = Log(tmp_path / "port", capacity=8, ordered_dedup=True)
    assert _ordered_history(tl) == _ordered_history(jl)
    assert tl.dedup_migrations >= 1
    _assert_ordered_logs_same(jl, tl)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir()
                   if p.name != ".clock")
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ordered_dedup_log_restarts_across_packages(tmp_path, writer):
    make = JaxLog if writer == "jax" else Log
    _ordered_history(make(tmp_path, capacity=8, ordered_dedup=True))
    jl = JaxLog(tmp_path, capacity=8, ordered_dedup=True)
    tl = Log(tmp_path, capacity=8, ordered_dedup=True)
    assert tl.records_parsed == jl.records_parsed > 0
    _assert_ordered_logs_same(jl, tl)
    # and the restarted logs keep committing identically
    for log in (jl, tl):
        log.commit({100: [1]}, evict=log.expired_rids(4))
    _assert_ordered_logs_same(jl, tl, n=102)


def test_ordered_dedup_equals_hash_dedup_for_monotone_rids(tmp_path):
    a = Log(tmp_path / "hash", capacity=256)
    b = Log(tmp_path / "ord", capacity=256, ordered_dedup=True)
    rid = 0
    for batch in range(7):
        rec = {rid + i: [batch, i] for i in range(3)}
        rid += 3
        ea, eb = a.expired_rids(5), b.expired_rids(5)
        assert sorted(ea) == eb
        a.commit(rec, evict=ea)
        b.commit(rec, evict=eb)
        assert a.committed() == b.committed()
        np.testing.assert_array_equal(a.took_effect(range(rid)),
                                      b.took_effect(range(rid)))
    b2 = Log(tmp_path / "ord", capacity=256, ordered_dedup=True)
    assert b2.committed() == a.committed()
    assert b2.expired_rids(2) == sorted(a.expired_rids(2))


def test_private_registry_gets_the_logs_counters(tmp_path):
    from repro_torch.obs.metrics import MetricsRegistry, get_registry
    mine = MetricsRegistry()
    shared = get_registry().counter("serving_commits_total").value
    log = Log(tmp_path, registry=mine, ordered_dedup=True)
    log.commit({1: [1]})
    log.commit({2: [2]})
    assert log.expired_rids(1) == [1]
    log.commit({3: [3]}, evict=log.expired_rids(1))
    assert mine.counter("serving_commits_total").value == 3
    assert mine.counter("serving_evicted_rids_total").value == 1
    assert get_registry().counter("serving_commits_total").value == shared
    again = Log(tmp_path, registry=MetricsRegistry(), ordered_dedup=True)
    assert again.records_parsed == 3 and again.committed() == {2: [2],
                                                               3: [3]}
    assert again.metrics.counter(
        "serving_records_parsed_total").value == 3


@pytest.mark.parametrize("kw", [{"shards": 4},
                                {"shards": 4, "rebalance": True}])
def test_sharded_log_crash_restart_matches_jax(tmp_path, kw):
    """A log whose dedup map is sharded over four shards (and may re-split
    them live) grows, snapshots, crashes with staged bytes evicted, and
    reopens with the answers of the JAX log on the same history."""
    log = Log(tmp_path / "port", capacity=16, **kw)
    n = _history(log)
    log.commit({n: [n]}, evict=log.expired_rids(20))
    log.io.crash(evict="random")
    jl = JaxLog(tmp_path / "jax", capacity=16)
    _history(jl)
    jl.commit({n: [n]}, evict=jl.expired_rids(20))
    tl = Log(tmp_path / "port", capacity=16, **kw)
    assert tl.committed() == JaxLog(tmp_path / "jax").committed()
    rids = list(range(-2, n + 3)) + [2**33]
    np.testing.assert_array_equal(tl.took_effect(rids),
                                  jl.took_effect(rids))
    assert log.dedup_migrations >= 1
    assert tl._dedup.n_shards == 4
    assert tl.dedup_rebalances == log.dedup_rebalances == 0
