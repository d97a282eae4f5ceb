"""The serving driver (traffic ``kind: "serve"``): exactly-once batch
serving through the program's ``ServeEngine`` and its ``RequestLog``.

One client in a closed loop sends the traffic's calls and waits for each
answer.  Every call holds the same prompt lengths, mixed, which the
engine groups by length into its batches, and sends again a few
requests of the call before.  Set-up serves the first call, which warms
every shape the later ones use, and a call of re-sends alone.  The
window runs whole calls while its time lasts.  Afterwards: every fresh
rid answered and committed once, every re-send answered with the
committed tokens, the log reopened from its files holding the same
results, and a seeded sample of the window's requests, the longest
prompt among them, read by the reference.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from collections import Counter

import torch

from . import program, traffic
from . import weights as W
from .probe import Probe


class Server:
    def __init__(self, spec, seed: int, device):
        from repro_torch.models.model import Model
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.serving.engine import ServeEngine
        self.spec, self.seed, self.device = spec, seed, device
        conf, tr = spec.config, spec.traffic
        cfg = program.arch_config(conf)
        t0 = time.perf_counter()
        w = spec.weights(seed, device)
        params = program.params(cfg, w, W.nested(w), trainable=False)
        del w
        self.log_dir = tempfile.mkdtemp(prefix="bench_log_")
        self.registry = MetricsRegistry()
        self.engine = ServeEngine(Model(cfg), params, log_dir=self.log_dir,
                                  device=device, registry=self.registry,
                                  **tr["engine"])
        self.n_new = tr["calls"]["new_tokens"]
        self.calls = traffic.ServeCalls(seed, tr["calls"],
                                        conf["model"]["vocab"])
        t1 = time.perf_counter()
        first = self.calls.next_call()
        self.answers = self.serve(first.requests())
        again = dict(list(first.fresh.items())[:len(first.fresh) // 8 + 1])
        self.serve(again)                             # the re-send path
        self.parts = {"build_s": t1 - t0,
                      "warm_calls_s": time.perf_counter() - t1}

    def serve(self, requests: dict) -> dict:
        return self.engine.serve(requests, n_new=self.n_new)

    def committed_rids(self) -> int:
        return self.registry.counter("serving_committed_rids_total").value

    def close(self) -> None:
        del self.engine
        program.free(self.device)
        shutil.rmtree(self.log_dir, ignore_errors=True)


def run(spec, seed: int, seconds: float, trace: bool, device,
        clock) -> dict:
    s = Server(spec, seed, device)
    eng = s.engine
    out = {"kind": "serve", "n_new": s.n_new, "setup_s": clock(),
           "parts": s.parts}
    c0 = s.committed_rids()
    answers = dict(s.answers)       # each fresh rid's first answer
    fresh, resends = [], []         # each call's fresh prompts; re-sends

    def call():
        c = s.calls.next_call()
        res = s.serve(c.requests())
        fresh.append(c.fresh)
        answers.update({r: res.get(r) for r in c.fresh})
        resends.append({r: res.get(r) for r in c.resent})
    out["trace"] = None
    if trace:
        from .trace import traced
        tr = spec.traffic["trace"]
        out["trace"] = traced(device, call, tr["calls"], tr["host_calls"],
                              spec.config["model"])
    n_pre, n_dec = len(eng.step_times["prefill_s"]), \
        len(eng.step_times["decode_step_s"])
    n_window = len(fresh)
    t0 = time.perf_counter()
    t0_ns = time.perf_counter_ns()
    ends = []
    with Probe(device) as probe:
        while True:              # whole calls, while the window lasts
            call()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["window_s"] = time.perf_counter() - t0
    out["parts"]["call_s"] = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    out["parts"].update(probe.readings())
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    epoch_us = (t0_ns - eng.tracer.epoch_ns) / 1e3
    window = fresh[n_window:]
    out.update(
        # the window's fresh requests as (count, prompt length) groups
        fresh_calls=[(n, S) for c in window for S, n in sorted(
            Counter(len(p) for p in c.values()).items())],
        prefill_s=eng.step_times["prefill_s"][n_pre:],
        decode_step_s=eng.step_times["decode_step_s"][n_dec:],
        commit_us=[r["dur_us"] for r in eng.tracer.records()
                   if r["span"] == "commit" and r["t_us"] >= epoch_us])
    n_fresh = sum(len(c) for c in fresh)
    out["attempted"] = n_fresh + sum(len(r) for r in resends)
    out["failed"] = sum(1 for c in fresh for x in c if answers[x] is None) \
        + sum(1 for r in resends for v in r.values() if v is None)

    # exactly-once: answered, committed once, re-sends answered alike,
    # the reopened log holding the same results
    faults = sum(1 for c in fresh for x in c
                 if len(answers[x] or ()) != s.n_new)
    faults += abs(s.committed_rids() - c0 - n_fresh)
    faults += sum(1 for r in resends for x, v in r.items()
                  if v != answers.get(x))
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving.engine import RequestLog
    live = eng.log.committed()
    again = RequestLog(s.log_dir, device=device,
                       registry=MetricsRegistry()).committed()
    faults += len(set(live) ^ set(again)) + sum(
        1 for k in set(live) & set(again) if live[k] != again[k])
    del again, live

    # the reference's sample of the window's requests: drawn from the
    # seed, the longest prompt in it
    flat = [(x, p) for c in window for x, p in c.items()]
    rng = traffic.seeded(seed, 6)
    k = min(spec.traffic["check"]["sample_requests"], len(flat))
    pick = list(rng.choice(len(flat), size=k, replace=False)) if flat else []
    longest = max((len(p) for _, p in flat), default=0)
    if pick and all(len(flat[i][1]) < longest for i in pick):
        idx = [i for i, (_, p) in enumerate(flat) if len(p) == longest]
        pick[0] = idx[int(rng.integers(len(idx)))]
    sample = [(flat[i][1], answers[flat[i][0]] or []) for i in pick]
    s.close()
    out.update(log_faults=faults, sample=sample)
    out["check"] = lambda: check(spec, seed, device, sample, faults)
    return out


def check(spec, seed: int, device, sample: list, faults: int,
          control: bool = False) -> dict:
    """The comparison's numbers: the widest gap of a sampled served token
    below the reference's best, and the log's faults.  A sampled request
    with a missing or short answer counts as a fault."""
    from ..reference.common import Prec
    from ..reference.serve import gaps
    n_new = spec.traffic["calls"]["new_tokens"]
    reqs = []
    for prompt, served in sample:
        if len(served) != n_new:
            faults += 1
            continue
        reqs.append((torch.as_tensor(prompt, device=device),
                     torch.as_tensor(served, device=device)))
    w = spec.weights(seed, device)
    g = gaps(w, spec.reference_module(), spec.config["model"], reqs,
             control=Prec("fp8") if control else None,
             rows=spec.config["serve"]["ref_rows"])
    del w
    program.free(device)
    nums = {"served_gap": g["served_gap"], "log_faults": faults,
            "_readings": {"tokens_read": g["tokens"]}}
    if control:
        nums["control_gap"] = g["control_gap"]
    return nums
