"""End-to-end driver on the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps with NVTraverse
checkpointing, inject a crash, resume, and verify the trajectory matches
an uninterrupted run.  On the card the steps run through the
``flash_attention`` forward and backward kernels, under deterministic
algorithms.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py [--steps 200] \
        [--device cpu]
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

import repro_torch.launch.train as train_mod
from repro_torch.configs.registry import get_arch
from repro_torch.core.batched import resolve_device
from repro_torch.launch.train import CUBLAS_WORKSPACE, run_training


def arch_100m():
    """~100M-parameter member of the qwen3 family."""
    base = get_arch("qwen3-1.7b")
    return dataclasses.replace(
        base, n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
        d_ff=1536, vocab=32000, param_dtype="float32",
        compute_dtype="float32", microbatches=1)


def main(argv=None):
    # before cuBLAS starts: deterministic GEMMs on the card need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    crash_at = args.crash_at or args.steps // 2 + 3
    # every 25 steps, as the reference; a third of a shorter run, so that
    # the crash always lands after a checkpoint
    ckpt_every = max(1, min(25, args.steps // 3))

    cfg = arch_100m()
    n = cfg.n_params()
    print(f"arch: qwen3-family reduced, {n/1e6:.0f}M params, "
          f"{args.steps} steps, crash at {crash_at}, checkpoint every "
          f"{ckpt_every}, on {dev}\n")

    # register the custom config so run_training can find it
    parse_arch = train_mod.parse_arch
    train_mod.parse_arch = lambda spec, dtype=None: cfg

    tmp = tempfile.mkdtemp(prefix="train_tiny_")
    try:
        kw = dict(arch="custom", steps=args.steps, ckpt_every=ckpt_every,
                  global_batch=8, seq_len=128, seed=1, device=dev)
        print("— reference run (no crash) —")
        ref = run_training(ckpt_dir=f"{tmp}/ref", **kw)
        print(f"  final loss {ref['final_loss']:.4f}; "
              f"fsync fences: {ref['io']['fences']}")

        print(f"— crashed run (dies at step {crash_at}) —")
        first = run_training(ckpt_dir=f"{tmp}/crash", crash_at=crash_at,
                             **kw)
        print(f"  crashed at step {first['crashed_at']}")

        print("— resumed run —")
        second = run_training(ckpt_dir=f"{tmp}/crash", **kw)
        print(f"  {second['log'][0]}")
        print(f"  final loss {second['final_loss']:.4f}")

        drift = abs(second["final_loss"] - ref["final_loss"])
        print(f"\ncrash-restart drift vs uninterrupted run: {drift:.2e}")
        assert drift < 1e-5, "resumed trajectory diverged!"
        assert ref["losses"][args.steps] < ref["losses"][1], "no learning?"
        print("resumed training is bit-faithful to the uninterrupted run ✓")
        return {"drift": drift, "ref": ref, "resumed": second,
                "steps": args.steps, "ckpt_every": ckpt_every}
    finally:
        train_mod.parse_arch = parse_arch
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
