"""Serving entry point: batched greedy requests against any arch (reduced
or full config) with the durable request log.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny:qwen2-7b \
        --requests 8 --new-tokens 8 [--crash-after 1] [--device cpu]

Without ``--device`` it runs on the card and fails when there is none.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from ..configs.registry import get_arch
from ..core.batched import resolve_device
from ..models.model import Model, prefix_tokens
from ..serving.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny:qwen2-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--crash-after", type=int, default=None,
                    help="crash after N committed batches (test recovery)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    requests = {i: rng.integers(0, cfg.vocab,
                                size=args.prompt_len).astype(np.int32)
                for i in range(args.requests)}
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="serve_log_")
    max_len = args.prompt_len + args.new_tokens + prefix_tokens(cfg)
    eng = ServeEngine(model, params, max_len=max_len, log_dir=log_dir,
                      batch_size=args.batch_size, device=dev)
    out = eng.serve(requests, n_new=args.new_tokens,
                    crash_after_batches=args.crash_after)
    print(json.dumps({"arch": cfg.name, "device": str(dev),
                      "committed": len(out), "log_dir": log_dir,
                      "sample": {str(k): out[k] for k in list(out)[:3]}},
                     indent=1))
    if args.crash_after is not None:
        print("crashed after", args.crash_after,
              "batches; re-run with --log-dir", log_dir, "to recover")


if __name__ == "__main__":
    main()
