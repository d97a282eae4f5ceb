"""The port's sharded durable map (``repro_torch.core.sharded``), the
sharded ``MembershipIndex`` backend and ``RequestLog(shards=)`` against
the JAX package on the CPU, bit for bit: per-shard state arrays, per-op
``ok``, every ``ShardCommitStats`` field, migration reports and index
answers, at 1, 2, 4 and 8 shards.

The JAX map needs one device per shard, and JAX takes its device count
from ``XLA_FLAGS`` before it starts.  So the reference side runs once per
test session in a subprocess with eight forced host devices (this file,
run as a script), which writes every seeded case's results to an
``.npz``; the tests drive the port through the same cases in process.
The port also runs all its shards on one device, so it is held against
its own single-device engine as well.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/test_torch_sharded.py OUT.npz
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

NB = 64
REPO = Path(__file__).resolve().parents[1]
STATS = ("ops_committed", "conflict_groups", "max_group",
         "coalesced_flushes", "coalesced_fences", "foreign_ops",
         "bucket_flushes")
FIELDS = ("key", "val", "nxt", "live", "head", "cursor", "flushes",
          "fences")

# name: (shards, capacity, splits, rounds, seed, n_lo, n_hi, key_hi); the
# batch sizes stay inside one power-of-two padding width per shard count,
# which keeps the reference's compiles few
MIXED = {
    "s1": (1, 4096, None, 6, 0, 33, 65, 50),
    "s2": (2, 4096, None, 6, 1, 33, 65, 50),
    "s4": (4, 4096, None, 6, 2, 33, 65, 50),
    "s8_dups": (8, 4096, None, 8, 3, 65, 129, 40),
    "s2_uneven": (2, 4096, (0, 12, NB), 5, 4, 65, 129, 180),
    "s4_uneven": (4, 4096, (0, 6, 12, 40, NB), 5, 5, 65, 129, 180),
}
MIGRATE = (1, 4)                     # shard counts of the growth case
REBALANCE = (1, 8)                   # shard counts of the re-split case


# --------------------------------------------------------------------- #
# the cases, the same code for both packages                             #
# --------------------------------------------------------------------- #
def _jax_maps():
    from repro.core.sharded import ShardedDurableMap
    from repro.launch.mesh import make_map_splits
    from repro.persistence.index import MembershipIndex
    from repro.serving.engine import RequestLog
    return dict(map=ShardedDurableMap, splits=make_map_splits,
                index=MembershipIndex, log=RequestLog)


def _port_maps():
    from repro_torch.core.sharded import ShardedDurableMap
    from repro_torch.launch.mesh import make_map_splits
    from repro_torch.persistence.index import MembershipIndex
    from repro_torch.serving.engine import RequestLog

    def cpu(cls):
        return lambda *a, **kw: cls(*a, device="cpu", **kw)
    return dict(map=cpu(ShardedDurableMap), splits=make_map_splits,
                index=cpu(MembershipIndex), log=cpu(RequestLog))


def host(m) -> dict:
    """A sharded map's stacked state as numpy (either package)."""
    if hasattr(m, "host"):
        return m.host()
    import jax
    st = jax.device_get(m.state)
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def put_items(out, tag, items):
    ks = sorted(items)
    out[f"{tag}/items"] = np.asarray(
        [(k, int(items[k][0]), items[k][1]) for k in ks],
        np.int64).reshape(-1, 3)


def put_stats(out, tag, stats):
    for f in STATS:
        out[f"{tag}/{f}"] = np.asarray(getattr(stats, f))


def put_state(out, tag, m):
    for f, a in host(m).items():
        out[f"{tag}/{f}"] = a
    out[f"{tag}/totals"] = np.asarray([m.flushes, m.fences])
    put_items(out, tag, m.items())


def batch(rng, n_lo, n_hi, key_hi):
    n = int(rng.integers(n_lo, n_hi))
    return (rng.integers(0, 2, size=n).astype(np.int32),
            rng.integers(0, key_hi, size=n).astype(np.int32),
            rng.integers(0, 1000, size=n).astype(np.int32))


def case_mixed(k, name) -> dict:
    S, cap, splits, rounds, seed, n_lo, n_hi, key_hi = MIXED[name]
    m = k["map"](S, capacity=cap, n_buckets=NB, splits=splits)
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(rounds):
        ok, stats = m.update(*batch(rng, n_lo, n_hi, key_hi))
        out[f"{name}/r{r}/ok"] = np.asarray(ok)
        put_stats(out, f"{name}/r{r}", stats)
    put_state(out, name, m)
    q = rng.integers(0, key_hi + 20, size=64).astype(np.int32)
    for f, a in zip(("exists", "live", "vals"), m.probe(q)):
        out[f"{name}/probe_{f}"] = np.asarray(a)
    out[f"{name}/chain"] = np.asarray(m.chain_stats(), np.float64)
    return out


def put_report(out, tag, rep):
    out[f"{tag}/report"] = np.asarray(
        [rep.rounds, rep.migrated, rep.foreign_ops, *rep.chain_before,
         *rep.chain_after], np.float64)
    out[f"{tag}/report_bf"] = np.asarray(rep.bucket_flushes)
    out[f"{tag}/splits"] = np.asarray(rep.splits_new)


def case_migrate(k, S) -> dict:
    """Growth and rehash: 400 keys, a quarter deleted, into a map of four
    times the pool and twice the buckets."""
    m = k["map"](S, capacity=1024, n_buckets=NB)
    ks = np.arange(1, 401, dtype=np.int32)
    m.insert(ks, ks * 7)
    m.delete(ks[::4])
    new, rep = m.migrate_to(capacity=4096, n_buckets=2 * NB,
                            buckets_per_round=9)
    out = {}
    put_report(out, f"migrate{S}", rep)
    put_state(out, f"migrate{S}", new)
    return out


def case_rebalance(k, S) -> dict:
    """A skew-correcting re-split mid-stream: boundaries from the rounds'
    per-bucket flush loads, then more traffic on the new split."""
    m = k["map"](S, capacity=8192, n_buckets=NB)
    rng = np.random.default_rng(31 + S)
    loads = np.zeros(NB, np.int64)
    out = {}
    for r in range(4):
        ok, stats = m.update(*batch(rng, 129, 161, 50))
        out[f"reb{S}/pre{r}/ok"] = np.asarray(ok)
        loads += np.asarray(stats.bucket_flushes)
    splits = k["splits"](NB, S, loads=loads) if S > 1 else (0, NB)
    rep = m.rebalance(splits, buckets_per_round=7)
    put_report(out, f"reb{S}", rep)
    for r in range(3):
        ok, stats = m.update(*batch(rng, 129, 161, 80))
        out[f"reb{S}/post{r}/ok"] = np.asarray(ok)
        put_stats(out, f"reb{S}/post{r}", stats)
    put_state(out, f"reb{S}", m)
    return out


def case_index(k, root) -> dict:
    """The sharded index: growth under keys that all hash to shard 0,
    removal and re-adding, and a sharded RequestLog opened twice on one
    directory."""
    from repro_torch.core.batched import bucket_of_np
    out = {}
    skewed = [k_ for k_ in range(1000)
              if int(bucket_of_np([k_ + 1], 128)[0]) // 64 == 0][:25]
    idx = k["index"](capacity=8, n_buckets=128, n_shards=2)
    for i in range(0, 20, 3):
        idx.add(skewed[i:i + 3])
    idx.update(add_keys=skewed[20:25], remove_keys=skewed[:5])
    out["skew/contains"] = idx.contains(skewed + [5000])
    out["skew/migrations"] = np.asarray([idx.migrations, idx.capacity])
    put_state(out, "skew", idx._backend.map)

    log = k["log"](root, shards=2)
    log.commit({1: [10], 2: [20]})
    log.commit({3: [30]}, evict=[1])
    out["log/first"] = log.is_committed([1, 2, 3])
    log2 = k["log"](root, shards=2)
    out["log/second"] = log2.is_committed([1, 2, 3])
    out["log/committed"] = np.asarray(
        [(r, *v) for r, v in sorted(log2.committed().items())], np.int64)
    return out


def run_all(k, root, multi: bool) -> dict:
    """Every case with more than one shard (``multi``), or with one."""
    def want(S):
        return (S > 1) == multi
    out = {}
    for name, case in MIXED.items():
        if want(case[0]):
            out.update(case_mixed(k, name))
    for S in filter(want, MIGRATE):
        out.update(case_migrate(k, S))
    for S in filter(want, REBALANCE):
        out.update(case_rebalance(k, S))
    if multi:
        out.update(case_index(k, root))
    return out


# --------------------------------------------------------------------- #
# the reference side, once per session                                   #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The forced-device reference run, started first so that it runs
    while this process computes the port's side."""
    d = tmp_path_factory.mktemp("jax_sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    with open(d / "out.txt", "w") as out:     # a file: no pipe to fill
        proc = subprocess.Popen(
            [sys.executable, __file__, str(d / "ref.npz")], env=env,
            stdout=out, stderr=subprocess.STDOUT)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port(jax_proc, tmp_path_factory):
    d = tmp_path_factory.mktemp("port_log")
    return {**run_all(_port_maps(), d, multi=True),
            **run_all(_port_maps(), d / "log1", multi=False)}


@pytest.fixture(scope="module")
def ref(jax_proc, port):
    proc, d = jax_proc
    # one shard needs no forced device: that side runs in process
    out = run_all(_jax_maps(), d / "log1", multi=False)
    assert proc.wait(timeout=300) == 0, (d / "out.txt").read_text()
    with np.load(d / "ref.npz") as z:
        out.update({k: z[k] for k in z.files})
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


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_rounds_match_jax_bit_for_bit(ref, port, name):
    """Per-round ok and ShardCommitStats, the final per-shard arrays,
    flush/fence totals, items, probes and chain stats."""
    _compare(ref, port, name)


@pytest.mark.parametrize("S", MIGRATE)
def test_migrate_to_growth_matches_jax(ref, port, S):
    _compare(ref, port, f"migrate{S}")
    rep = ref[f"migrate{S}/report"]
    assert rep[2] == 0 and rep[1] == 300         # no foreign op; 300 live


@pytest.mark.parametrize("S", REBALANCE)
def test_rebalance_matches_jax(ref, port, S):
    _compare(ref, port, f"reb{S}")


@pytest.mark.parametrize("part", ["skew", "log"])
def test_sharded_index_and_log_match_jax(ref, port, part):
    _compare(ref, port, part)


def test_port_index_resurrects_without_growth():
    """A removed member's node is resurrected in place: filling the
    pools, removing members and re-adding them allocates nothing, so the
    exact fit check runs no growth migration."""
    from repro_torch.persistence.index import MembershipIndex
    idx = MembershipIndex(capacity=64, n_buckets=128, n_shards=2,
                          device="cpu")
    keys = list(range(100, 160))
    for i in range(0, len(keys), 16):
        idx.add(keys[i:i + 16])
    grown = idx.migrations
    idx.remove(keys[:40])
    idx.add(keys[:40])
    assert idx.migrations == grown
    assert idx.contains(keys).all()
    idx.update(add_keys=[500, 2**40], remove_keys=[100, 101, 500])
    assert idx.contains([100, 101, 500, 2**40, 102]).tolist() == \
        [False, False, False, True, True]


# --------------------------------------------------------------------- #
# the port against its own single-device engine                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_port_matches_its_single_device_engine(S):
    import torch
    from repro_torch.core import batched as TB
    from repro_torch.core.sharded import ShardedDurableMap, items_of_state
    m = ShardedDurableMap(S, capacity=8192, n_buckets=NB, device="cpu")
    ref = TB.make_state(8192, NB, "cpu")
    rng = np.random.default_rng(100 + S)
    for _ in range(6):
        ops, ks, vs = batch(rng, 40, 200, 60)
        ref, ok_ref, st_ref = TB.update_parallel(ref, ops, ks, vs, NB)
        ok, st = m.update(ops, ks, vs)
        assert ok.tolist() == ok_ref.tolist()
        assert st.bucket_flushes.tolist() == st_ref.bucket_flushes.tolist()
        assert st.foreign_ops.tolist() == [0] * S
        assert st.total_ops_committed == int(st_ref.ops_committed)
        assert st.total_coalesced_flushes == int(st_ref.coalesced_flushes)
        assert st.global_coalesced_fences == 2 * int(st.max_group.max())
    assert items_of_state(ref) == m.items()
    assert (m.flushes, m.fences) == (int(ref.flushes), int(ref.fences))
    q = torch.as_tensor(rng.integers(0, 90, size=128).astype(np.int32))
    f_ref, v_ref = TB.lookup(ref, q, NB)
    f, v = m.lookup(q.numpy())
    assert f.tolist() == f_ref.tolist() and v.tolist() == v_ref.tolist()


def test_port_index_absorbs_8x_its_seed_capacity_over_4_shards():
    """A 4-shard index seeded at capacity C absorbs 8C inserts under
    live mixed traffic, growing by migration rounds; every answer
    matches a set model."""
    from repro_torch.persistence.index import MembershipIndex
    C = 64
    idx = MembershipIndex(capacity=C, n_buckets=128, n_shards=4,
                          device="cpu")
    rng = np.random.default_rng(41)
    members, nxt = set(), 1
    while nxt <= 8 * C:
        fresh = list(range(nxt, nxt + 32))
        nxt += 32
        rem = [int(x) for x in rng.integers(1, nxt, size=8)
               if int(x) in members]
        idx.update(add_keys=fresh, remove_keys=rem)
        members |= set(fresh)
        members -= set(rem)
    assert idx.migrations >= 1
    probe = [int(x) for x in rng.integers(1, nxt + 50, size=300)]
    assert idx.contains(probe).tolist() == [x in members for x in probe]


def test_bad_splits_and_uneven_single_shard():
    from repro_torch.core.sharded import ShardedDurableMap, even_splits
    from repro.core.sharded import even_splits as jax_even
    assert even_splits(64, 4) == jax_even(64, 4)
    with pytest.raises(ValueError):
        ShardedDurableMap(2, capacity=64, n_buckets=63, device="cpu")
    with pytest.raises(ValueError):
        ShardedDurableMap(1, capacity=256, n_buckets=NB,
                          splits=(0, 10, NB), device="cpu")
    m = ShardedDurableMap(1, capacity=512, n_buckets=NB, splits=(0, NB),
                          device="cpu")
    ks = np.arange(1, 101, dtype=np.int32)
    assert m.insert(ks, ks * 3)[0].all()
    ok, _ = m.delete(np.array([1, 1, 999], np.int32))
    assert ok.tolist() == [True, False, False]
    f, v = m.lookup(np.array([1], np.int32))
    assert not f[0] and int(v[0]) == 0      # lookup's not-found contract
    ex, live, pv = m.probe(np.array([1, 2, 999], np.int32))
    assert ex.tolist() == [True, True, False]
    assert live.tolist() == [False, True, False] and int(pv[1]) == 6


def test_map_split_helpers_match_jax():
    from repro.launch import mesh as JM
    from repro_torch.launch import mesh as TM
    rng = np.random.default_rng(5)
    for S in (2, 4, 8):
        for _ in range(5):
            loads = rng.integers(0, 50, NB) * (rng.random(NB) < 0.3)
            assert TM.make_map_splits(NB, S, loads=loads) == \
                JM.make_map_splits(NB, S, loads=loads)
            cur = TM.make_map_splits(NB, S)
            for th in (1.0, 1.3, 2.0):
                assert TM.replan_splits(cur, loads, threshold=th) == \
                    JM.replan_splits(cur, loads, threshold=th)
    with pytest.raises(ValueError):
        TM.make_map_splits(NB, 4, loads=np.zeros(NB - 1))


if __name__ == "__main__":
    import jax
    assert jax.device_count() >= 8, "needs 8 forced host devices"
    out = Path(sys.argv[1])
    np.savez(out, **run_all(_jax_maps(), out.parent / "log", multi=True))
