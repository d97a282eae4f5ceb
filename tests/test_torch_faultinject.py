"""The port's crash-fault injection (``repro_torch.robustness``) against
the JAX package's: each port scenario visits the same ``(kind, target)``
crash sites as its JAX twin, and sweeps under the ``none``, ``random`` and
``torn`` eviction adversaries recover every invariant (no acked op lost,
prefix durability, oracle equivalence) on the CPU.  The ``rebalance``
scenario at 4 shards needs four JAX devices, so its reference sites come
from a subprocess with forced host devices (this file, run as a
script)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.robustness import faultinject as JF
from repro_torch.persistence.manifest import StagedIO
from repro_torch.robustness import KINDS, faultinject as TF

CPU = {"device": "cpu"}
LAYERS = ("log", "log2", "checkpoint", "migrate", "rebalance", "ordered")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import CRASH_SITES  # noqa: E402


def sites(ss):
    return [(s.kind, s.target) for s in ss]


@pytest.mark.parametrize("layer", LAYERS)
def test_port_scenario_visits_the_jax_scenarios_sites(layer):
    port = TF.enumerate_sites(TF.SCENARIOS[layer], CPU)
    assert sites(port) == sites(JF.enumerate_sites(JF.SCENARIOS[layer]))
    assert [s.index for s in port] == list(range(len(port)))
    assert len(port) == CRASH_SITES[layer]      # the card run's pin
    assert {s.kind for s in port} <= set(KINDS)


def jax_sites_at_4_shards():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    proc = subprocess.run([sys.executable, __file__], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [tuple(x) for x in json.loads(proc.stdout.splitlines()[-1])]


def test_rebalance_at_4_shards_visits_the_jax_scenarios_sites():
    kw = {"device": "cpu", "n_shards": 4}
    port = sites(TF.enumerate_sites(TF.SCENARIOS["rebalance"], kw))
    assert port == jax_sites_at_4_shards()
    assert len(port) == CRASH_SITES["rebalance4"]   # the card run's pin


def test_rebalance_sweep_at_4_shards_recovers_every_invariant():
    rep = TF.sweep(TF.SCENARIOS["rebalance"],
                   evict_modes=("none", "random", "torn"),
                   scenario_kw={"device": "cpu", "n_shards": 4})
    assert rep["failures"] == [], rep["failures"]
    assert rep["runs"] == 3 * rep["n_sites"]


def test_registry_holds_the_four_ported_scenarios():
    """Named for the slice that ported four; the registry now holds all
    six of the reference's scenarios."""
    assert sorted(TF.SCENARIOS) == sorted(LAYERS) == sorted(JF.SCENARIOS)
    assert KINDS == ("flush", "fence", "publish", "trim")
    assert {s.kind for s in TF.enumerate_sites(TF.SCENARIOS["ordered"],
                                               CPU)} == set(KINDS)


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("evict", ["none", "random", "torn"])
def test_sweep_at_every_site_recovers_every_invariant(layer, evict):
    rep = TF.sweep(TF.SCENARIOS[layer], evict_modes=(evict,),
                   scenario_kw=CPU)
    assert rep["failures"] == [], rep["failures"]
    assert rep["tested_sites"] == list(range(rep["n_sites"]))
    assert rep["runs"] == rep["n_sites"] == CRASH_SITES[layer]


def test_crash_plan_fires_before_the_site_and_goes_inert(tmp_path):
    io = StagedIO(tmp_path)
    plan = TF.CrashPlan(crash_at=2).attach(io)
    io.write("a", b"1")
    io.flush("a")                                # site 0
    io.fence()                                   # site 1
    io.write("b", b"2")
    with pytest.raises(TF.CrashPoint) as e:
        io.flush("b")                            # site 2: crashes first
    assert e.value.site == TF.CrashSite(2, "flush", "b")
    assert (tmp_path / "a").read_bytes() == b"1"
    assert not (tmp_path / "b").exists()         # staged, lost
    assert plan.completed_sites() == plan.sites[:2]
    io.write("c", b"3")
    io.flush("c")                                # inert after firing
    io.fence()
    assert len(plan.sites) == 3 and (tmp_path / "c").exists()
    with pytest.raises(ValueError, match="unknown site kind"):
        TF.CrashPlan().on_site("sync")


def test_fuzz_mode_is_seed_deterministic(tmp_path):
    fired = []
    for _ in range(2):
        plan = TF.CrashPlan(p_crash=0.3, seed=7)
        fired.append(TF._run_once(TF.SCENARIOS["log"], plan, CPU))
    assert fired[0] == fired[1] is not None


def test_budget_indices_match_jax():
    for n, b in [(10, None), (10, 3), (25, 7), (5, 50), (2, 1)]:
        assert TF._budget_indices(n, b) == JF._budget_indices(n, b)


def test_replay_and_live_helpers_match_jax():
    rng = np.random.default_rng(3)
    rounds = [{"ops": rng.integers(0, 2, 12), "ks": rng.integers(0, 6, 12),
               "vs": rng.integers(0, 99, 12)} for _ in range(4)]
    a, b = {1: (False, 5)}, {1: (False, 5)}
    TF._replay_rounds(a, rounds)
    JF._replay_rounds(b, rounds)
    assert a == b and TF._live(a) == JF._live(b)


if __name__ == "__main__":
    print(json.dumps(sites(JF.enumerate_sites(
        JF.SCENARIOS["rebalance"], {"n_shards": 4}))))
