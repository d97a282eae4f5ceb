"""Live cross-shard rebalancing on the PyTorch port, in 80 lines.

A 4-shard durable map gets hammered on keys that all hash into ONE
shard's bucket range.  The :class:`AutoRebalancePolicy` notices the
load imbalance from the per-bucket flush counters, re-plans the
boundaries as load quantiles, and re-splits the map *while the stream
keeps committing* — no operator call, no stop-the-world drain.  At the
end the map must still answer exactly like a dict.  The four shards
share one card (or the host, with ``--device cpu``).

    PYTHONPATH=src python examples/torch_rebalance_live.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import batched as B
from repro_torch.core.batched import resolve_device
from repro_torch.core.rebalance import (AutoRebalancePolicy,
                                        RebalancingShardedMap)

S, NB = 4, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the shards (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"=== live rebalance: {S} shards, {NB} buckets ===\n")
    # an adversarial key set: everything hashes into shard 0's range
    hot = [k for k in range(4000)
           if int(B.bucket_of_np(np.asarray([k], np.int32), NB)[0])
           < NB // S][:48]
    m = RebalancingShardedMap(
        S, capacity=8192, n_buckets=NB, rounds_per_update=2,
        policy=AutoRebalancePolicy(threshold=1.3, min_load=64,
                                   check_every=2), device=dev)
    print(f"even splits {m.splits}; streaming mixed ops on {len(hot)} "
          f"keys owned entirely by shard 0...")
    rng = np.random.default_rng(0)
    model = {}
    seen_trigger = False
    for step in range(30):
        ks = np.asarray(rng.choice(hot, 48), np.int32)
        ops = rng.integers(0, 2, 48).astype(np.int32)
        vs = rng.integers(0, 1000, 48).astype(np.int32)
        ok, _ = m.update(ops, ks, vs)
        for o, k, v, okk in zip(ops, ks, vs, ok):
            if o == B.OP_INSERT and okk:
                model[int(k)] = int(v)
            elif o == B.OP_DELETE and okk:
                model.pop(int(k), None)
        if m.rebalancing and not seen_trigger:
            seen_trigger = True
            print(f"step {step:2d}: policy fired (imbalance "
                  f"{m.last_trigger_imbalance:.2f}x) — re-splitting to "
                  f"{m.splits} under traffic, frontier {m.frontier}")
        elif not m.rebalancing and seen_trigger and \
                m.rebalances_completed == 1:
            seen_trigger = False
            r = m.last_report
            print(f"step {step:2d}: rebalance complete — {r.migrated} "
                  f"keys drained in {r.rounds} bounded rounds, "
                  f"{m.pulls_total} pulled by user batches, "
                  f"foreign_ops={r.foreign_ops}")

    assert m.rebalances_completed >= 1, "the skew must trigger a re-split"
    assert m.splits[1] <= NB // S, "the hot range must have shrunk"
    live = {k: v for k, (l, v) in m.items().items() if l}
    assert live == model, "live rebalance must be invisible to content"
    f, v = m.lookup(np.asarray(hot, np.int32))
    for k, ff, vv in zip(hot, f, v):
        assert bool(ff) == (k in model) and (not ff or int(vv) == model[k])
    print(f"\nfinal splits {m.splits} after "
          f"{m.rebalances_completed} rebalance(s); "
          f"{len(live)} live keys — all answers match the dict oracle ✓")
    return {"splits": m.splits, "rebalances": m.rebalances_completed,
            "live": live}


if __name__ == "__main__":
    main()
