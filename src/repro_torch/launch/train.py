"""Fault-tolerant end-to-end training (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny:qwen3-1.7b \
        --steps 60 --ckpt-every 10 --ckpt-dir /tmp/ckpt [--crash-at 25] \
        [--device cpu]

Without ``--device`` it runs on the card and fails when there is none.
As in the reference:

  * an NVTraverse checkpoint commit every k steps (delta shards, one
    fence, the atomic manifest publish) of ``{"params", "opt"}``, the
    pipeline's cursor in the manifest's ``aux``;
  * crash injection between steps or inside a commit (after the shards
    or before the publish); a restart resumes from the newest committed
    manifest with the cursor restored, and must continue bit for bit as
    an uninterrupted run;
  * a heartbeat file each step, and a straggler event for a step longer
    than ``--step-deadline``.

On the card, a resumed run repeats the same bits only if every step does:
training runs under ``torch.use_deterministic_algorithms(True)``, with
``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts (``main`` sets it; a
caller that starts CUDA itself sets it first, as ``chip_smoke.py`` does),
and the port's attention kernels use no atomics.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path

import torch

from ..configs.base import ShapeConfig
from ..configs.registry import get_arch
from ..core.batched import resolve_device
from ..data.pipeline import TokenPipeline
from ..models.model import Model
from ..persistence.checkpoint import CheckpointManager
from ..training.optimizer import make_optimizer
from ..training.train_loop import make_train_step

CUBLAS_WORKSPACE = ":4096:8"


def parse_arch(spec: str, dtype: str = None):
    """``name`` or ``tiny:name``; ``dtype`` (e.g. ``bfloat16``) replaces
    the parameter and compute dtypes."""
    cfg = get_arch(spec)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on the card for the duration (the CPU's
    ops already are); raises where cuBLAS was not told its workspace."""
    if device.type != "cuda":
        yield
        return
    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError("set CUBLAS_WORKSPACE_CONFIG (e.g. "
                           f"{CUBLAS_WORKSPACE!r}) before CUDA starts: "
                           "training on the card must be deterministic")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def run_training(*, arch: str, steps: int, ckpt_dir: str,
                 ckpt_every: int = 10, global_batch: int = 8,
                 seq_len: int = 64, crash_at: int = -1,
                 crash_phase: str = "between",
                 step_deadline: float = 120.0,
                 policy: str = "nvtraverse", seed: int = 0,
                 device=None, dtype: str = None) -> dict:
    dev = resolve_device(device)
    cfg = parse_arch(arch, dtype)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    model = Model(cfg)
    opt = make_optimizer(cfg)
    train_step = make_train_step(model, cfg, opt)
    pipeline = TokenPipeline(cfg, shape, seed=seed,
                             microbatches=max(1, cfg.microbatches))
    mgr = CheckpointManager(ckpt_dir, policy=policy, device=dev)
    hb_path = Path(ckpt_dir) / "heartbeat.json"
    log = []

    with deterministic(dev):
        # ---- restore-or-init -------------------------------------------- #
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            trainable=True)
        named = dict(params.named_parameters())
        opt_state = opt.init(params)
        start_step = 0
        man, restored = mgr.restore({"params": named, "opt": opt_state})
        if man is not None:
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(restored["params"][n])
            opt_state = restored["opt"]
            start_step = man.step
            pipeline.restore(man.aux.get("pipeline"))
            log.append(f"resumed from committed step {man.step}")

        step = start_step
        losses = {}
        stragglers = []
        while step < steps:
            t0 = time.time()
            batch = pipeline.next_batch()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch, step)
            loss = float(metrics["loss"])
            step += 1
            dt = time.time() - t0
            if dt > step_deadline:
                stragglers.append({"step": step, "seconds": dt})
            hb_path.parent.mkdir(parents=True, exist_ok=True)
            hb_path.write_text(json.dumps(
                {"step": step, "t": time.time(), "loss": loss}))
            losses[step] = loss

            if crash_at == step and crash_phase == "between":
                mgr.io.crash(evict="none")
                return {"crashed_at": step, "losses": losses, "log": log}

            if step % ckpt_every == 0 or step == steps:
                crash_after = (crash_phase if crash_at == step
                               and crash_phase in ("shards", "manifest")
                               else None)
                man = mgr.save(step, {"params": named, "opt": opt_state},
                               aux={"pipeline": pipeline.snapshot(),
                                    "arch": cfg.name, "loss": loss},
                               crash_after=crash_after)
                if man is None:             # injected crash mid-commit
                    mgr.io.crash(evict="none")
                    return {"crashed_at": step, "losses": losses,
                            "log": log}

    return {"final_step": step, "losses": losses, "log": log,
            "stragglers": stragglers,
            "final_loss": losses.get(step),
            "io": mgr.io.counters.snapshot()}


def main(argv=None) -> None:
    # before cuBLAS starts: its workspace must be fixed for deterministic
    # GEMMs on the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny:qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--crash-phase", default="between",
                    choices=["between", "shards", "manifest"])
    ap.add_argument("--policy", default="nvtraverse",
                    choices=["nvtraverse", "izraelevitz"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="parameter and compute dtype (default: the "
                         "arch's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = run_training(arch=args.arch, steps=args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       global_batch=args.global_batch,
                       seq_len=args.seq_len, crash_at=args.crash_at,
                       crash_phase=args.crash_phase, policy=args.policy,
                       seed=args.seed, device=args.device, dtype=args.dtype)
    print(json.dumps({k: v for k, v in out.items() if k != "losses"},
                     indent=1))
    if out.get("final_loss") is not None:
        print(f"final loss: {out['final_loss']:.4f}")
    else:
        print("final loss: n/a (already at target step)")


if __name__ == "__main__":
    main()
