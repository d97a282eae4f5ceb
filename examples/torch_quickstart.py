"""Quickstart on the PyTorch port: the NVTraverse transformation in 60
lines.

Builds Harris's linked list in traversal form, runs it under the three
policies the paper compares, crashes it, recovers it, and prints the
flush/fence economy that is the paper's headline result.

The instruction-level layer is host numpy in both packages, so this
example needs no device.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core.harris_list import HarrisList
from repro_torch.core.pmem import PMem
from repro_torch.core.policies import get_policy
from repro_torch.core.traversal import run_operation


def main():
    print("=== NVTraverse quickstart: Harris list, 512 keys ===\n")
    stats = {}
    for policy_name in ("volatile", "izraelevitz", "nvtraverse"):
        mem = PMem(1 << 18)
        ds = HarrisList(mem)
        pol = get_policy(policy_name)
        for k in range(0, 1024, 2):
            run_operation(ds, pol, "insert", (k, k))
        mem.counters.reset()
        n_ops = 300
        for i in range(n_ops):
            k = (i * 7) % 1024
            run_operation(ds, pol, "find", (k,))
            if i % 10 == 0:
                run_operation(ds, pol, "delete", (k,))
                run_operation(ds, pol, "insert", (k, k))
        c = mem.counters
        stats[policy_name] = c.snapshot()
        print(f"{policy_name:12s}: {c.flushes/n_ops:8.1f} flushes/op "
              f"{c.fences/n_ops:8.1f} fences/op "
              f"(traverse-phase flushes: {c.traverse_flushes})")

    ratio = stats["izraelevitz"]["fences"] / max(
        1, stats["nvtraverse"]["fences"])
    print(f"\nNVTraverse uses {ratio:.1f}x fewer fences than the "
          f"Izraelevitz et al. general transform")
    print("(the paper reports 13.5x-39.6x throughput on Optane from "
          "exactly this economy)\n")

    print("=== crash + recovery (Theorem 4.2 in action) ===")
    mem = PMem(1 << 16, seed=1)
    ds = HarrisList(mem)
    pol = get_policy("nvtraverse")
    for k in range(20):
        run_operation(ds, pol, "insert", (k, k * 10))
    print("before crash:", sorted(ds.contents())[:10], "...")
    mem.crash(evict="random", p_evict=0.5)   # lose the volatile view
    ds.disconnect()                          # recovery = Supplement 1
    recovered = sorted(ds.contents())
    print("after crash+recovery:", recovered[:10], "...")
    assert recovered == list(range(20)), "completed inserts must survive"
    print("all committed operations survived the crash. ✓")


if __name__ == "__main__":
    main()
