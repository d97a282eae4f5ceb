"""Serving example on the PyTorch port: batched requests with a durable
request log.

Serves a batch of prompts against a reduced qwen2-7b-family model, crashes
the engine mid-run, restarts it, and shows that committed results survive
(exactly-once) while in-flight requests are transparently re-executed.
The prefills run through the ``flash_attention`` kernel on the card (its
plain version with ``--device cpu``).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs.registry import get_arch, tiny
from repro_torch.core.batched import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = tiny(get_arch("qwen2-7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    requests = {i: rng.integers(0, cfg.vocab, size=12).astype(np.int32)
                for i in range(8)}

    tmp = tempfile.mkdtemp(prefix="serve_")
    try:
        eng = ServeEngine(model, params, max_len=32, log_dir=tmp,
                          batch_size=2, device=dev)
        print("serving 8 requests, crash injected after 2 batches...")
        partial = eng.serve(requests, n_new=6, crash_after_batches=2)
        print(f"  committed before crash: {sorted(partial)}")

        print("restarting engine on the same log...")
        eng2 = ServeEngine(model, params, max_len=32, log_dir=tmp,
                           batch_size=2, device=dev)
        full = eng2.serve(requests, n_new=6)
        print(f"  committed after recovery: {sorted(full)}")
        assert set(full) == set(requests)
        for rid in partial:
            assert full[rid] == partial[rid], "committed result changed!"
        print("\nfirst 3 generations:")
        for rid in range(3):
            print(f"  request {rid}: {full[rid]}")
        print("\ncommitted results survived the crash unmodified; "
              "in-flight requests were re-served exactly once ✓")
        return {"partial": partial, "full": full}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
