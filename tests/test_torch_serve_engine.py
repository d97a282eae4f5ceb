"""The port's ServeEngine against the JAX package's on ``tiny(zamba2-7b)``:
the same parameters (the JAX init carried across as numpy arrays) and the
same requests give identical committed greedy tokens; a crash after one
batch and a restart on the same log keep exactly-once; and a log written
by one package's engine is finished by the other's."""
import jax
import numpy as np
import pytest

from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import tiny as jtiny
from repro.models.model import build_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs.registry import get_arch, tiny
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.obs.metrics import get_registry
from repro_torch.serving.engine import ServeEngine

N_NEW = 5


@pytest.fixture(scope="module")
def env():
    jcfg = jtiny(jget_arch("zamba2-7b"))
    cfg = tiny(get_arch("zamba2-7b"))
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(4)
    # two prompt lengths, one of them ragged against the SSD chunk (16)
    requests = {rid: rng.integers(0, cfg.vocab, size=20 if rid < 4 else 16
                                  ).astype(np.int32) for rid in range(8)}
    return dict(jm=jm, jp=jp, tm=Model(cfg), tp=tp, requests=requests,
                max_len=20 + N_NEW)


def _port(env, d, **kw):
    return ServeEngine(env["tm"], env["tp"], max_len=env["max_len"],
                       log_dir=d, batch_size=2, device="cpu", **kw)


def _jax(env, d):
    return JaxEngine(env["jm"], env["jp"], max_len=env["max_len"],
                     log_dir=d, batch_size=2)


def test_port_and_jax_engines_commit_identical_tokens(env, tmp_path):
    want = _jax(env, tmp_path / "jax").serve(env["requests"], n_new=N_NEW)
    eng = _port(env, tmp_path / "port")
    got = eng.serve(env["requests"], n_new=N_NEW)
    assert got == want and len(got) == 8
    assert all(len(v) == N_NEW for v in got.values())
    # four batches (two of length 16, then two of length 20), each timed
    assert len(eng.step_times["prefill_s"]) == 4
    assert len(eng.step_times["decode_step_s"]) == 4 * N_NEW


def test_crash_and_restart_hold_exactly_once(env, tmp_path):
    reg = get_registry()
    first = _port(env, tmp_path).serve(env["requests"], n_new=N_NEW,
                                       crash_after_batches=1)
    assert sorted(first) == [4, 5]           # the shortest prompts first
    hits = reg.counter("serving_dedup_hits_total").value
    again = _port(env, tmp_path)
    assert list(again.took_effect([4, 5, 0])) == [True, True, False]
    out = again.serve(env["requests"], n_new=N_NEW)
    assert reg.counter("serving_dedup_hits_total").value - hits == 2
    assert {r: out[r] for r in first} == first
    assert len(out) == 8
    records = sorted(p.name for p in tmp_path.glob("log_*.json"))
    assert len(records) == 4                 # each batch committed once
    # served again: every rid is a dedup hit and nothing is recomputed
    n = len(again.step_times["prefill_s"])
    assert again.serve(env["requests"], n_new=N_NEW) == out
    assert len(again.step_times["prefill_s"]) == n


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_one_packages_log_is_finished_by_the_other(env, tmp_path, first,
                                                   second):
    make = {"jax": _jax, "port": _port}
    whole = make[first](env, tmp_path / "whole").serve(env["requests"],
                                                        n_new=N_NEW)
    part = make[first](env, tmp_path / "log").serve(
        env["requests"], n_new=N_NEW, crash_after_batches=2)
    assert len(part) == 4
    rest = make[second](env, tmp_path / "log").serve(env["requests"],
                                                      n_new=N_NEW)
    assert rest == whole


def test_unported_log_backends_raise(env, tmp_path):
    """The log backends once unported now serve: a sharded and a
    sharded, rebalancing dedup map commit the JAX engine's tokens and
    keep exactly-once through a crash.  Params on another device still
    raise."""
    want = _jax(env, tmp_path / "jax").serve(env["requests"], n_new=N_NEW)
    for i, kw in enumerate(({"log_shards": 2},
                            {"log_shards": 4, "log_rebalance": True})):
        d = tmp_path / f"port{i}"
        first = _port(env, d, **kw).serve(env["requests"], n_new=N_NEW,
                                          crash_after_batches=1)
        again = _port(env, d, **kw)
        assert again.took_effect(sorted(first)).all()
        assert again.serve(env["requests"], n_new=N_NEW) == want
        assert len(list(d.glob("log_*.json"))) == 4
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(env["tm"], env["tp"], max_len=8, log_dir=tmp_path,
                    device="meta")


def test_ordered_dedup_engines_commit_identical_tokens(env, tmp_path):
    """With the dedup set on the ordered map and a retention window, the
    port's engine commits the JAX engine's tokens, evicts the same rids,
    and a crash and restart keep exactly-once."""
    kw = dict(ordered_dedup=True, retain=3)
    jeng = JaxEngine(env["jm"], env["jp"], max_len=env["max_len"],
                     log_dir=tmp_path / "jax", batch_size=2, **kw)
    want = jeng.serve(env["requests"], n_new=N_NEW)
    part = _port(env, tmp_path / "port", **kw).serve(
        env["requests"], n_new=N_NEW, crash_after_batches=2)
    assert len(part) == 4
    eng = _port(env, tmp_path / "port", **kw)
    got = eng.serve(env["requests"], n_new=N_NEW)
    assert got == want and len(got) == 8
    assert eng.log.committed() == jeng.log.committed()
    rids = list(range(8))
    np.testing.assert_array_equal(eng.took_effect(rids),
                                  jeng.took_effect(rids))
    assert eng.log.expired_rids(2) == jeng.log.expired_rids(2)
