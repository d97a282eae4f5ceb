"""The port's migration core and membership index against the JAX
reference on the CPU: migrated tables, index members, answers, growth
counts and the index's map arrays must all be identical."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import batched as JB
from repro.core import migrate as JM
from repro.core.migrate import migrate_state as jax_migrate
from repro.persistence.index import MembershipIndex as JaxIndex
from repro.persistence.index import _pad_pow2 as jax_pad
from repro.persistence.index import owner_step as jax_owner_step
from repro_torch.core import batched as TB
from repro_torch.core import migrate as TM
from repro_torch.core.migrate import drain_range, host_state, migrate_state
from repro_torch.persistence.index import (MembershipIndex, _pad_pow2,
                                           owner_step)


def assert_same(ref, port, ctx=""):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: field {f}")


def _built_pair(nb, seed):
    """The same mixed history (key 0, deletes, resurrects) in both."""
    rng = np.random.default_rng(seed)
    js = JB.make_state(512, nb)
    ts = TB.make_state(512, nb, "cpu")
    for _ in range(4):
        ops = rng.integers(0, 2, size=64)
        ks = rng.integers(0, 150, size=64)
        vs = rng.integers(0, 1000, size=64)
        js, _, _ = JB.update_parallel(js, jnp.asarray(ops), jnp.asarray(ks),
                                      jnp.asarray(vs), nb)
        ts, _, _ = TB.update_parallel(ts, ops, ks, vs, nb)
    assert_same(js, ts, "built")
    return js, ts


@pytest.mark.parametrize("new_nb,bpr", [(None, None), (24, 3)])
def test_migrate_state_bit_identical_to_jax(new_nb, bpr):
    nb = 8
    js, ts = _built_pair(nb, seed=4)
    jn, jrep = jax_migrate(js, nb, 1024, new_nb, bpr)
    tn, trep = migrate_state(ts, nb, 1024, new_nb, bpr)
    assert_same(jn, tn, "migrated")
    assert tuple(jrep) == tuple(trep)
    old = host_state(ts)
    ks, vs = drain_range(old, 0, nb)
    assert sorted(ks.tolist()) == sorted(
        int(k) for k, l in zip(old["key"][1:], old["live"][1:]) if l)


def test_host_helpers_match_jax():
    """``host_state``/``items_of_host``/``drain_range``/``_probe_np`` and
    ``owner_step`` give the reference's answers on the same map."""
    js, ts = _built_pair(8, seed=6)
    jold, told = JM.host_state(js), host_state(ts)
    assert JM.items_of_host(jold) == TM.items_of_host(told)
    for lo, hi in [(0, 8), (2, 5)]:
        for a, b in zip(JM.drain_range(jold, lo, hi),
                        drain_range(told, lo, hi)):
            np.testing.assert_array_equal(a, b)
    q = np.arange(-2, 160, dtype=np.int32)
    for a, b in zip(JM._probe_np(js, q, 8), TM._probe_np(ts, q, 8)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rel = "step_00000042/shard_3.npy"
    assert owner_step(rel) == jax_owner_step(rel) == 42


def test_migrate_state_raises_when_the_new_pool_is_too_small():
    _, ts = _built_pair(8, seed=4)
    with pytest.raises(RuntimeError, match="overflowed"):
        migrate_state(ts, 8, 16)


def _assert_index_same(ji, ti, probe, ctx):
    assert ji.members == ti.members, ctx
    assert ji.migrations == ti.migrations, ctx
    assert ji.capacity == ti.capacity and ji.n_buckets == ti.n_buckets
    np.testing.assert_array_equal(ji.contains(probe), ti.contains(probe),
                                  err_msg=ctx)
    assert_same(ji.state, ti.state, ctx)


def test_index_growth_past_capacity_matches_jax():
    ji, ti = JaxIndex(capacity=8), MembershipIndex(capacity=8, device="cpu")
    keys = list(range(100, 180))              # 80 members through an 8-pool
    for i in range(0, len(keys), 16):
        ji.add(keys[i:i + 16])
        ti.add(keys[i:i + 16])
        _assert_index_same(ji, ti, keys + [5, 999], f"add {i}")
    assert ti.migrations >= 1 and ti.capacity >= 81
    assert ti.contains(keys).all()


def test_index_out_of_range_and_mixed_rounds_match_jax():
    rng = np.random.default_rng(21)
    ji = JaxIndex(capacity=16, n_buckets=8)
    ti = MembershipIndex(capacity=16, n_buckets=8, device="cpu")
    probe = list(range(-3, 70)) + [2**31 - 1, 2**31 - 2, 2**40, -2**40]
    for step in range(8):
        adds = rng.integers(0, 64, size=12).tolist()
        rems = rng.integers(0, 64, size=8).tolist()
        if step == 3:
            adds += [2**40, -5, 2**31 - 1]
        if step == 5:
            rems += [2**40, -5]
        ji.update(adds, rems)
        ti.update(adds, rems)
        _assert_index_same(ji, ti, probe, f"step {step}")
        assert_same(ji.last_stats, ti.last_stats, f"stats {step}")


def test_pad_pow2_pads_with_the_last_op():
    xs = np.array([4, 9, 2], np.int32)
    np.testing.assert_array_equal(_pad_pow2(xs), jax_pad(xs))
    assert _pad_pow2(xs).tolist() == [4, 9, 2, 2]


@pytest.mark.parametrize("kw", [{"n_shards": 2}, {"auto_rebalance": True}])
def test_unported_backends_raise(kw):
    """The backend options once unported now build their backend: the
    sharded map with ``n_shards``; ``auto_rebalance`` alone keeps the
    single-device map, as in the reference.  Either grows past its seed
    pool and answers like a set."""
    from repro.persistence.index import MembershipIndex as JaxIndex
    idx = MembershipIndex(capacity=8, device="cpu", **kw)
    keys = list(range(1, 40))
    idx.add(keys)
    idx.remove(keys[::3])
    want = set(keys) - set(keys[::3])
    assert idx.contains(range(50)).tolist() == [k in want
                                                for k in range(50)]
    assert idx.migrations >= 1 and idx.rebalances == 0
    sharded = "n_shards" in kw
    assert type(idx._backend).__name__ == \
        ("_ShardedBackend" if sharded else "_SingleBackend")
    if not sharded:
        jidx = JaxIndex(capacity=8, **kw)
        jidx.add(keys)
        jidx.remove(keys[::3])
        for f in jidx.state._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jidx.state, f)),
                getattr(idx.state, f).numpy(), err_msg=f)


def test_growth_first_call_events_match_jax():
    """Index growth records one capacity-ladder event per fresh
    (pool, buckets, padded width) signature of the migrate seam, the same
    events as the reference's tracker."""
    from repro.obs.compile import get_tracker as jax_tracker
    from repro_torch.obs.compile import get_tracker
    jt, tt = jax_tracker(), get_tracker()
    jt.reset()
    tt.reset()
    ji, ti = JaxIndex(capacity=8), MembershipIndex(capacity=8, device="cpu")
    for i in range(6):
        ks = list(range(10 * i, 10 * i + 10))
        ji.add(ks)
        ti.add(ks)
    assert ti.migrations == ji.migrations >= 2
    key = lambda trk: [(e.site, e.key, e.trigger) for e in trk.events]
    assert key(tt) == key(jt)
    assert {e.trigger for e in tt.events} == {"capacity_ladder"}
