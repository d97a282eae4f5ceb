"""The training driver (traffic ``kind: "train"``).

Set-up builds one train step (the program's ``make_train_step`` with its
model, AdamW and the benchmark's weights) and drives it through its first
steps on the feed's first rows; the same object then runs in the window,
one step after another on fresh rows, each step's loss read as the
program's trainer reads it.  Afterwards the reference follows the first
steps from the same weights and rows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import judge, program, traffic
from . import weights as W
from .probe import Probe


class Trainer:
    """The program's train step over the benchmark's weights and feed,
    driven through its first ``warmup_steps`` steps, with the numbers the
    comparison reads from them (``prog``)."""

    def __init__(self, spec, seed: int, device):
        from repro_torch.launch.train import deterministic
        from repro_torch.models.model import Model
        from repro_torch.training.optimizer import (AdamWConfig, Optimizer,
                                                    adamw)
        from repro_torch.training.train_loop import make_train_step
        self.spec, self.seed, self.device = spec, seed, device
        conf, tr = spec.config, spec.traffic
        m, tc = conf["model"], conf["train"]
        self.B, self.M, self.S = tc["global_batch"], tc["microbatches"], \
            tr["seq_len"]
        self.warm = tr["warmup_steps"]
        cfg = program.arch_config(conf, microbatches=self.M)
        self.prog = {"losses": []}
        t0 = time.perf_counter()
        w = spec.weights(seed, device)
        self.params = program.params(cfg, w, W.nested(w), trainable=True)
        opt = adamw(AdamWConfig(**tc["optimizer"]))

        def update(grads, state, p, step):
            if step == 0:      # the first gradient as the optimizer gets it
                self.prog["first_grad"] = {n: float(g.norm())
                                           for n, g in grads.items()}
            with torch.profiler.record_function("bench.optimizer"):
                return opt.update(grads, state, p, step)
        self.step_fn = make_train_step(Model(cfg), cfg,
                                       Optimizer(opt.init, update))
        self.opt_state = opt.init(self.params)
        self.deterministic = lambda: deterministic(device)
        self.step = 0
        t1 = time.perf_counter()
        with self.deterministic():
            for _ in range(self.warm):
                self.prog["losses"].append(self())
        t2 = time.perf_counter()
        w0 = spec.weights(seed, device)
        cur = dict(self.params.named_parameters())
        self.prog["change"] = {n: float((cur[n].detach().float()
                                         - w0[n].float()).norm()) for n in w0}
        # the blocks stay in the allocator's cache: the window's first
        # step allocates nothing that set-up's steps did not
        del w0, cur, w
        self.parts = {"build_s": t1 - t0, "first_steps_s": t2 - t1,
                      "change_s": time.perf_counter() - t2}

    def rows(self, i: int) -> np.ndarray:
        """Step ``i``'s rows, [B, S + 1]."""
        return traffic.train_rows(self.seed, i, self.B, self.S,
                                  self.spec.config["model"]["vocab"])

    def __call__(self) -> float:
        """One step on the next rows; its loss, read as the trainer does."""
        rows = self.rows(self.step)
        if self.M > 1:
            rows = rows.reshape(self.M, self.B // self.M, self.S + 1)
        self.params, self.opt_state, met = self.step_fn(
            self.params, self.opt_state, {"tokens": rows}, self.step)
        self.step += 1
        return float(met["loss"])

    def close(self) -> None:
        del self.params, self.opt_state, self.step_fn
        program.free(self.device)


def reference(spec, seed: int, device, prog: dict, prec: str = "f32",
              rows_kept: int = None, ref: dict = None) -> tuple:
    """(the comparison's numbers, the reference's readings): the reference
    in float32 follows the first steps.  With ``prec="fp8"`` or
    ``rows_kept`` a second reference (the control, or a planted fault)
    takes the program's place against the float32 one, which ``ref``
    passes in when it was run already."""
    from ..reference.common import Prec
    from ..reference.train import run as ref_run
    conf, tr = spec.config, spec.traffic
    tc = conf["train"]
    w = spec.weights(seed, device)
    batches = [torch.as_tensor(traffic.train_rows(
        seed, i, tc["global_batch"], tr["seq_len"], conf["model"]["vocab"]),
        device=device) for i in range(tr["warmup_steps"])]
    args = (w, spec.reference_module(), conf["model"], batches,
            tc["optimizer"])
    if ref is None:
        ref = ref_run(*args, Prec("f32"), rows=tc["ref_rows"])
    if prec != "f32" or rows_kept:
        prog = ref_run(*args, Prec(prec), rows=tc["ref_rows"],
                       rows_kept=rows_kept)
    del w, batches
    program.free(device)
    nums = judge.train_numbers(prog, ref)
    nums["_leaves"] = {"prog": {k: prog[k] for k in ("first_grad", "change")},
                       "ref": {k: ref[k] for k in ("first_grad", "change")}}
    return nums, ref


def run(spec, seed: int, seconds: float, trace: bool, device,
        clock) -> dict:
    """Set-up, then with ``trace`` a few steps under the profiler, then
    the window of untraced steps."""
    t = Trainer(spec, seed, device)
    out = {"kind": "train", "batch": t.B, "seq": t.S, "setup_s": clock(),
           "trace": None, "parts": t.parts}
    losses = []
    with t.deterministic():
        if trace:
            from .trace import traced
            tr = spec.traffic["trace"]
            out["trace"] = traced(device, lambda: losses.append(t()),
                                  tr["steps"], tr["host_steps"],
                                  spec.config["model"])
        t0 = time.perf_counter()
        ends = []        # each step's end (its loss read), from the start
        with Probe(device) as probe:
            while True:
                losses.append(t())
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
        steps = len(ends)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["window_s"] = time.perf_counter() - t0
    out["parts"]["step_s"] = [b - a for a, b in
                              zip([0.0] + ends[:-1], ends)]
    out["parts"].update(probe.readings())
    out.update(steps=steps, attempted=len(losses),
               failed=sum(1 for x in losses if not np.isfinite(x)))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    prog = t.prog
    t.close()
    out["check"] = lambda: reference(spec, seed, device, prog)[0]
    return out
