"""The port's live cross-shard rebalancing (``repro_torch.core.rebalance``)
against the JAX package on the CPU, bit for bit: a live re-split under
mixed traffic equals the blocking one followed by the same batches (and
a dict model), a dead node in the new map vetoes the old map's live copy,
journals are byte-identical and recover in either package, a crash at
every frontier recovers to the round boundary, and the auto policy fires
on skew with the reference's gauges.

One shard runs the JAX side in process.  More shards need one JAX device
each, so that side runs once per test session in a subprocess with eight
forced host devices (this file, run as a script), which writes its
results and journals under a temporary directory:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/test_torch_rebalance.py OUT_DIR
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

NB = 32
BPR = 4                                  # 32 buckets / 4 = 8 drain rounds
REPO = Path(__file__).resolve().parents[1]
FIELDS = ("key", "val", "nxt", "live", "head", "cursor", "flushes",
          "fences")
# shards: the splits a live rebalance moves to
SPLITS = {1: (0, NB), 2: (0, 12, NB), 4: (0, 6, 12, 20, NB)}
EQUIV = (1, 4)                  # shard counts of the equivalence case
SKEW = (4,)                     # ... and of the auto trigger


def _kit(pkg):
    """The classes of one package, on the CPU."""
    if pkg == "jax":
        from repro.core import rebalance as R, sharded as S
        from repro.obs.metrics import get_registry
        from repro.persistence.index import MembershipIndex
        from repro.serving.engine import RequestLog
        return dict(live=R.RebalancingShardedMap, blk=S.ShardedDurableMap,
                    policy=R.AutoRebalancePolicy, reg=get_registry,
                    index=MembershipIndex, log=RequestLog)
    from repro_torch.core import rebalance as R, sharded as S
    from repro_torch.obs.metrics import get_registry
    from repro_torch.persistence.index import MembershipIndex
    from repro_torch.serving.engine import RequestLog

    def cpu(cls):
        return lambda *a, **kw: cls(*a, device="cpu", **kw)
    return dict(live=cpu(R.RebalancingShardedMap),
                blk=cpu(S.ShardedDurableMap), policy=R.AutoRebalancePolicy,
                reg=get_registry, index=cpu(MembershipIndex),
                log=cpu(RequestLog))


def host(m) -> dict:
    if hasattr(m, "host"):
        return m.host()
    import jax
    st = jax.device_get(m.state)
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def put_state(out, tag, m):
    for f, a in host(m).items():
        out[f"{tag}/{f}"] = a


def live_items(m) -> dict:
    return {k: v for k, (l, v) in m.items().items() if l}


def put_live(out, tag, m):
    out[f"{tag}/live_items"] = np.asarray(sorted(live_items(m).items()),
                                          np.int64).reshape(-1, 2)


def batch(rng, n, key_hi=200):
    return (rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, key_hi, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32))


def case_equivalence(k, S) -> dict:
    """A live rebalance under mixed traffic beside the blocking rebalance
    followed by the same batches."""
    splits = SPLITS[S]
    m = k["live"](S, capacity=2048, n_buckets=NB, rounds_per_update=1)
    blk = k["blk"](S, capacity=2048, n_buckets=NB)
    rng = np.random.default_rng(7 + S)
    out = {}
    for i in range(3):
        ops, ks, vs = batch(rng, 60)
        out[f"eq{S}/pre{i}"] = np.asarray(m.update(ops, ks, vs)[0])
        blk.update(ops, ks, vs)
    blk.rebalance(splits, buckets_per_round=5)
    m.start_rebalance(splits, buckets_per_round=5)
    probe = np.arange(220, dtype=np.int32)
    i = 0
    while m.rebalancing:
        ops, ks, vs = batch(rng, 40)
        out[f"eq{S}/live{i}"] = np.asarray(m.update(ops, ks, vs)[0])
        out[f"eq{S}/blk{i}"] = np.asarray(blk.update(ops, ks, vs)[0])
        f, v = m.lookup(probe)
        out[f"eq{S}/look{i}"] = np.stack([np.asarray(f, np.int32),
                                          np.asarray(v)])
        i += 1
    rep = m.last_report
    out[f"eq{S}/report"] = np.asarray(
        [rep.rounds, rep.migrated, rep.foreign_ops, m.pulls_total,
         m.rebalances_completed, *rep.chain_after], np.float64)
    out[f"eq{S}/splits"] = np.asarray(m.splits)
    put_state(out, f"eq{S}/live", m.map)
    put_state(out, f"eq{S}/blk", blk)
    put_live(out, f"eq{S}/live", m)
    put_live(out, f"eq{S}/blk", blk)
    return out


def journal_history(m):
    """A seeded map, a rebalance, one drain, then user deletes and
    inserts, then one more drain: the journal holds both round kinds."""
    ks = np.arange(1, 121, dtype=np.int32)
    m.insert(ks, ks * 5)
    m.delete(ks[::4])
    S = m.n_shards
    m.start_rebalance(SPLITS[S], buckets_per_round=BPR)
    m.rebalance_round()
    m.delete(np.array([2, 3, 4], np.int32))
    m.insert(np.array([500, 2], np.int32), np.array([7, 8], np.int32))
    m.rebalance_round()


def case_journal(k, S, root) -> dict:
    m = k["live"](S, capacity=1024, n_buckets=NB, root=root)
    journal_history(m)
    out = {}
    put_state(out, f"jr{S}/new", m._reb["new"])
    out[f"jr{S}/frontier"] = np.asarray([m.frontier])
    return out


def case_skew(k, S) -> dict:
    """Traffic hammering keys of one shard starts and completes a
    re-split by itself; gauges as the policy read them."""
    from repro_torch.core.batched import bucket_of_np
    reg = k["reg"]()
    reg.reset()
    nb_local = NB // S
    hot = [x for x in range(4000)
           if int(bucket_of_np([x], NB)[0]) < nb_local][:40]
    m = k["live"](S, capacity=4096, n_buckets=NB, rounds_per_update=2,
                  policy=k["policy"](threshold=1.3, min_load=64,
                                     check_every=2))
    rng = np.random.default_rng(3)
    out = {}
    for i in range(24):
        ks = np.asarray(rng.choice(hot, 48), np.int32)
        ops = rng.integers(0, 2, 48).astype(np.int32)
        vs = rng.integers(0, 1000, 48).astype(np.int32)
        out[f"skew{S}/ok{i}"] = np.asarray(m.update(ops, ks, vs)[0])
    out[f"skew{S}/summary"] = np.asarray(
        [m.rebalances_completed, m.last_trigger_imbalance,
         m.imbalance()], np.float64)
    out[f"skew{S}/splits"] = np.asarray(m.splits)
    out[f"skew{S}/gauges"] = np.asarray(
        [reg.gauge("map_shard_load", shard=str(s)).value
         for s in range(S)]
        + [reg.gauge("map_load_imbalance").value,
           reg.gauge("map_trigger_imbalance").value], np.float64)
    put_state(out, f"skew{S}", m.map)
    put_live(out, f"skew{S}", m)
    return out


def case_index(k, root) -> dict:
    """A 2-shard auto-rebalancing index grows through the live wrapper,
    and a RequestLog opts in end to end."""
    idx = k["index"](capacity=64, n_buckets=128, n_shards=2,
                     auto_rebalance=True)
    keys = list(range(100, 260))
    for i in range(0, len(keys), 32):
        idx.add(keys[i:i + 32])
    idx.update(add_keys=[500], remove_keys=keys[:50])
    out = {"index/contains": idx.contains(keys + [500, 7]),
           "index/counts": np.asarray([idx.migrations, idx.rebalances,
                                       idx.capacity])}
    put_state(out, "index", idx._backend.map.map)
    log = k["log"](root, shards=2, rebalance=True)
    log.commit({1: [10], 2: [20]})
    log.commit({3: [30]}, evict=[1])
    out["log/answers"] = log.is_committed([1, 2, 3])
    out["log/counts"] = np.asarray([log.dedup_migrations,
                                    log.dedup_rebalances])
    return out


def run_multi(k, root) -> dict:
    out = {}
    for S in EQUIV[1:]:
        out.update(case_equivalence(k, S))
    out.update(case_journal(k, 2, root / "jr2"))
    for S in SKEW:
        out.update(case_skew(k, S))
    out.update(case_index(k, root / "log"))
    return out


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The forced-device reference run, started first so that it runs
    while this process computes the port's side."""
    d = tmp_path_factory.mktemp("jax_rebalance")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    with open(d / "out.txt", "w") as out:     # a file: no pipe to fill
        proc = subprocess.Popen([sys.executable, __file__, str(d)],
                                env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port(jax_proc, tmp_path_factory):
    d = tmp_path_factory.mktemp("port_rebalance")
    out = run_multi(_kit("port"), d)
    out.update(case_equivalence(_kit("port"), 1))
    out.update(case_journal(_kit("port"), 1, d / "jr1"))
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def ref(jax_proc, port):
    proc, d = jax_proc
    # one shard needs no forced device: that side runs in process
    out = case_equivalence(_kit("jax"), 1)
    out.update(case_journal(_kit("jax"), 1, d / "jr1"))
    assert proc.wait(timeout=300) == 0, (d / "out.txt").read_text()
    with np.load(d / "ref.npz") as z:
        out.update({k: z[k] for k in z.files})
    out["dir"] = d
    return out


def _compare(ref, port, prefix):
    keys = sorted(k for k in ref if k.split("/")[0] == prefix)
    assert keys and keys == sorted(k for k in port
                                   if k.split("/")[0] == prefix)
    for key in keys:
        a, b = ref[key], np.asarray(port[key])
        assert a.shape == b.shape, key
        if a.dtype.kind in "iub" and b.dtype.kind in "iub":
            assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


def dir_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("S", EQUIV)
def test_live_equals_blocking_and_matches_jax(ref, port, S):
    _compare(ref, port, f"eq{S}")
    # live == blocking: every ok flag and the final content
    assert port[f"eq{S}/live/live_items"].tolist() == \
        port[f"eq{S}/blk/live_items"].tolist()
    i = 0
    while f"eq{S}/live{i}" in port:
        assert port[f"eq{S}/live{i}"].tolist() == \
            port[f"eq{S}/blk{i}"].tolist()
        i += 1
    assert i > 0 and port[f"eq{S}/report"][2] == 0    # no foreign op


@pytest.mark.parametrize("S", [1, 2])
def test_journals_byte_identical_and_recover_across(ref, port, S):
    """The same history writes the same journal bytes, and the port
    recovers the reference's journal to the same in-flight state."""
    from repro_torch.core.rebalance import RebalancingShardedMap
    _compare(ref, port, f"jr{S}")
    jdir, tdir = ref["dir"] / f"jr{S}", port["dir"] / f"jr{S}"
    assert dir_bytes(jdir) == dir_bytes(tdir) != {}
    rec = RebalancingShardedMap.recover(jdir, S, device="cpu")
    assert rec.frontier == int(ref[f"jr{S}/frontier"][0])
    for f in FIELDS:
        np.testing.assert_array_equal(rec._reb["new"].host()[f],
                                      ref[f"jr{S}/new/{f}"], err_msg=f)


def test_jax_recovers_the_ports_journal(port):
    from repro.core.rebalance import RebalancingShardedMap as JaxMap
    import jax
    rec = JaxMap.recover(port["dir"] / "jr1", 1)
    st = jax.device_get(rec._reb["new"].state)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      port[f"jr1/new/{f}"], err_msg=f)
    rec.run_rebalance()
    live = {k: v for k, (l, v) in rec.items().items() if l}
    assert live[500] == 7 and live[2] == 8 and 3 not in live


@pytest.mark.parametrize("S", SKEW)
def test_auto_trigger_fires_on_skew_with_the_reference_gauges(ref, port,
                                                              S):
    _compare(ref, port, f"skew{S}")
    done, trig, _ = port[f"skew{S}/summary"]
    assert done >= 1 and trig > 1.3
    assert port[f"skew{S}/splits"][1] <= NB // S     # the hot range shrank


def test_index_and_requestlog_live_rebalance_match_jax(ref, port):
    _compare(ref, port, "index")
    _compare(ref, port, "log")
    assert port["index/contains"].tolist() == \
        [False] * 50 + [True] * 110 + [True, False]
    assert port["index/counts"][0] >= 1          # grew
    assert port["log/answers"].tolist() == [False, True, True]


# --------------------------------------------------------------------- #
# single-shard cases, the JAX side in process                             #
# --------------------------------------------------------------------- #
def test_dead_in_new_vetoes_live_in_old():
    """A key deleted mid-rebalance stays dead: its dead node in the new
    map vetoes the old copy for lookups and every later drain."""
    for pkg in ("jax", "port"):
        m = _kit(pkg)["live"](1, capacity=1024, n_buckets=NB)
        ks = np.arange(1, 51, dtype=np.int32)
        m.insert(ks, ks * 3)
        m.start_rebalance((0, NB), buckets_per_round=1)
        m.delete(ks)
        assert not np.asarray(m.lookup(ks)[0]).any()
        before = m.migrated_total
        while m.rebalancing:
            m.rebalance_round()
        assert not np.asarray(m.lookup(ks)[0]).any()
        assert all(not l for l, _ in m.items().values())
        assert m.migrated_total == before
        if pkg == "jax":
            want = host(m.map)
    for f in FIELDS:
        np.testing.assert_array_equal(host(m.map)[f], want[f], err_msg=f)


def test_quiescent_live_rebalance_is_the_blocking_one_bit_for_bit():
    k = _kit("port")

    def seeded(m):
        ks = np.arange(1, 201, dtype=np.int32)
        m.insert(ks, ks * 3)
        m.delete(ks[::3])
        return m
    live = seeded(k["live"](1, capacity=1024, n_buckets=NB))
    blk = seeded(k["blk"](1, capacity=1024, n_buckets=NB))
    live.start_rebalance((0, NB), buckets_per_round=5)
    live.run_rebalance()
    blk.rebalance((0, NB), buckets_per_round=5)
    a, b = host(live.map), host(blk)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert live.last_report.migrated > 0
    assert live.last_report.foreign_ops == 0


def test_start_rebalance_rejects_in_flight_and_undersized():
    m = _kit("port")["live"](1, capacity=256, n_buckets=NB)
    ks = np.arange(1, 101, dtype=np.int32)
    m.insert(ks, ks)
    m.start_rebalance((0, NB))
    with pytest.raises(RuntimeError):
        m.start_rebalance((0, NB))
    m.run_rebalance()
    with pytest.raises(ValueError):      # 100 live keys into a 64-pool
        m.start_rebalance((0, NB), capacity=64)


def test_rebalance_state_header_bytes_match_jax():
    from repro.core.rebalance import RebalanceState as J
    from repro_torch.core.rebalance import RebalanceState as T
    h = dict(phase="rebalancing", frontier=8, n_buckets=NB,
             capacity_old=1024, capacity_new=2048, splits_old=(0, 16, NB),
             splits_new=(0, 4, NB), buckets_per_round=4, n_rounds=3)
    assert T(**h).to_bytes() == J(**h).to_bytes()
    assert T.from_bytes(J(**h).to_bytes()) == T(**h)


def _seeded_live(root):
    m = _kit("port")["live"](1, capacity=1024, n_buckets=NB, root=root)
    ks = np.arange(1, 121, dtype=np.int32)
    m.insert(ks, ks * 5)
    m.delete(ks[::4])
    return m


@pytest.fixture(scope="module")
def boundaries(tmp_path_factory):
    """(frontier, new-map arrays) at every round boundary of an
    uninterrupted run and the final adopted arrays, from the port and
    from the reference (equal to each other)."""
    from repro.core.rebalance import RebalancingShardedMap as JaxMap
    out = []
    for pkg in ("port", "jax"):
        root = tmp_path_factory.mktemp(pkg) / "j"
        if pkg == "port":
            m = _seeded_live(root)
        else:
            m = JaxMap(1, capacity=1024, n_buckets=NB, root=root)
            ks = np.arange(1, 121, dtype=np.int32)
            m.insert(ks, ks * 5)
            m.delete(ks[::4])
        m.start_rebalance((0, NB), buckets_per_round=BPR)
        bounds = []
        while m.rebalancing:
            bounds.append((m.frontier, host(m._reb["new"])))
            m.rebalance_round()
        bounds.append((NB, host(m.map)))
        out.append(bounds)
    for (fa, a), (fb, b) in zip(*out):
        assert fa == fb and all(np.array_equal(a[f], b[f]) for f in FIELDS)
    return out[0]


@pytest.mark.parametrize("crash_round", list(range(NB // BPR + 1)))
def test_crash_replay_every_frontier(tmp_path, boundaries, crash_round):
    """A crash between rebalance rounds at every frontier recovers to the
    round boundary bit for bit and resumes to the uninterrupted end."""
    from repro_torch.core.rebalance import RebalancingShardedMap
    n_rounds = len(boundaries) - 1
    m = _seeded_live(tmp_path)
    m.start_rebalance((0, NB), buckets_per_round=BPR)
    for _ in range(min(crash_round, n_rounds)):
        m.rebalance_round()
    m.crash()
    rec = RebalancingShardedMap.recover(tmp_path, 1, device="cpu")
    if crash_round < n_rounds:
        assert rec.rebalancing
        assert rec.frontier == boundaries[crash_round][0]
        got = host(rec._reb["new"])
        for f in FIELDS:
            np.testing.assert_array_equal(
                got[f], boundaries[crash_round][1][f], err_msg=f)
        rec.run_rebalance()
    else:
        assert not rec.rebalancing
    got = host(rec.map)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], boundaries[-1][1][f],
                                      err_msg=f)


def test_unfenced_round_is_lost_fenced_round_survives(tmp_path):
    from repro_torch.core.rebalance import RebalancingShardedMap
    m = _seeded_live(tmp_path)
    m.start_rebalance((0, NB), buckets_per_round=BPR)
    m.rebalance_round()
    pre = host(m._reb["new"])
    m.io.write("reb_0001/round.tmp", b"torn")   # staged, never fenced
    m.crash()
    rec = RebalancingShardedMap.recover(tmp_path, 1, device="cpu")
    assert rec.frontier == BPR
    got = host(rec._reb["new"])
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], pre[f], err_msg=f)


def test_index_growth_mid_rebalance_counts_dead_in_old_keys():
    """A key whose only node is dead in the frozen old map allocates on
    re-insert: the fit check counts it, grows, and drops no member."""
    idx = _kit("port")["index"](capacity=16, n_buckets=NB, n_shards=1,
                                auto_rebalance=True)
    keys = list(range(1, 9))
    idx.add(keys)
    idx.remove([1, 2])
    idx._backend.map.start_rebalance((0, NB), buckets_per_round=2)
    idx.add([1, 2] + list(range(100, 108)))
    assert idx.contains(keys[2:] + [1, 2] + list(range(100, 108))).all()
    assert idx.migrations >= 1


def test_auto_trigger_declines_unfittable_plan(monkeypatch):
    """When the load-quantile plan cannot hold the live content, the
    auto policy declines (and counts it) instead of failing the user's
    update."""
    from repro_torch.launch import mesh
    k = _kit("port")
    m = k["live"](1, capacity=32, n_buckets=NB, rounds_per_update=1,
                  policy=k["policy"](threshold=1.3, min_load=1,
                                     check_every=1))
    ks = np.arange(1, 25, dtype=np.int32)
    m.insert(ks, ks)
    with pytest.raises(ValueError):
        m.start_rebalance((0, NB), capacity=16)
    monkeypatch.setattr(mesh, "replan_splits",
                        lambda s, l, threshold: (tuple(s), 9.9))
    calls = {}
    orig = m.start_rebalance

    def tiny_start(splits, **kw):
        calls["hit"] = True
        return orig(splits, capacity=16, **kw)

    monkeypatch.setattr(m, "start_rebalance", tiny_start)
    reg = k["reg"]()
    declined = reg.counter("map_rebalance_declined_total").value
    m.loads[0] = 100
    ok, _ = m.insert(np.array([1000], np.int32), np.array([1], np.int32))
    assert calls.get("hit") and not m.rebalancing and bool(ok[0])
    assert int(m.loads.sum()) <= 2
    assert reg.counter("map_rebalance_declined_total").value == declined + 1


if __name__ == "__main__":
    import jax
    assert jax.device_count() >= 8, "needs 8 forced host devices"
    out_dir = Path(sys.argv[1])
    np.savez(out_dir / "ref.npz", **run_multi(_kit("jax"), out_dir))
