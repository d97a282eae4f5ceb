"""What the comparison is there to fail, failing it, at the cells' tiny
forms on the CPU: the control (the reference computed in float8, one
step below the configuration's bfloat16, in the program's place), and
every fault a cell can have, planted in the program under a whole run
whose look for a card is skipped.  The same readings at full size come
from ``bench/control.py`` on the card."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from bench import run as bench_run
from bench.harness import serve, train
from bench.harness.cells import Spec
from bench.harness.judge import verdict

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SEED = 2**31 + 29
CELLS = {w["traffic"].split("-")[0] + ":" + w["config"]: w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
TRAIN = [v for k, v in CELLS.items() if k.startswith("train")]
SERVE = [v for k, v in CELLS.items() if k.startswith("serve")]


def spec_of(workload: str) -> Spec:
    bench_run.prepare(ROOT)
    return Spec(ROOT, workload, tiny=True)


def correct(workload: str) -> tuple:
    out, _ = bench_run.run_cell(spec_of(workload), SEED, 0.0, False, CPU)
    return out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails(workload):
    spec = spec_of(workload)
    nums, _ = train.reference(spec, SEED, CPU, None, prec="fp8")
    assert not verdict(nums, spec.limits())[0], nums


@pytest.mark.parametrize("workload", SERVE)
def test_serve_control_fails(workload):
    spec = spec_of(workload)
    rec = serve.run(spec, SEED, 0.0, False, CPU, bench_run.clock)
    nums = serve.check(spec, SEED, CPU, rec["sample"], rec["log_faults"],
                       control=True)
    assert verdict(nums, spec.limits())[0]
    nums["served_gap"] = nums["control_gap"]
    assert not verdict(nums, spec.limits())[0], nums


def _state_unchanged(monkeypatch):
    """The train step hands back its parameters and state untouched."""
    from repro_torch.training import optimizer
    orig = optimizer.adamw
    monkeypatch.setattr(optimizer, "adamw", lambda *a, **k: (
        optimizer.Optimizer(orig(*a, **k).init, lambda g, s, p, st: (p, s))))


def _half_batch(monkeypatch):
    """The loss is the mean over the first half of each batch's rows."""
    from repro_torch.models.model import Model
    orig = Model.loss
    monkeypatch.setattr(Model, "loss", lambda self, p, b: orig(
        self, p, {k: v[:v.shape[0] // 2] for k, v in b.items()}))


def _token_altered(monkeypatch):
    """Each request's second generated token is replaced where the engine
    produces it."""
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine._greedy_batch

    def bad(self, prompts, n_new):
        out = orig(self, prompts, n_new)
        out[:, 1] = (out[:, 1] + 1) % self.model.cfg.vocab
        return out
    monkeypatch.setattr(ServeEngine, "_greedy_batch", bad)


def _half_committed(monkeypatch):
    """Half of each batch's results never reach the log."""
    from repro_torch.serving.engine import RequestLog
    orig = RequestLog.commit

    def bad(self, results, evict=()):
        keep = dict(list(results.items())[:max(1, len(results) // 2)])
        return orig(self, keep, evict)
    monkeypatch.setattr(RequestLog, "commit", bad)


def _decode_state_unchanged(monkeypatch):
    """A decode step leaves its caches as it found them."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.models.model import Model
    orig = Model.decode_step

    def bad(self, params, tokens, caches, pos):
        keep = [t.clone() for t in tree_leaves(caches)]
        out = orig(self, params, tokens, caches, pos)
        for t, k in zip(tree_leaves(caches), keep):
            t.copy_(k)
        return out
    monkeypatch.setattr(Model, "decode_step", bad)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", TRAIN)
def test_train_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = correct(workload)
    assert not ok, checks


@pytest.mark.parametrize("fault", [_token_altered, _half_committed,
                                   _decode_state_unchanged],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", SERVE)
def test_serve_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = correct(workload)
    assert not ok, checks
