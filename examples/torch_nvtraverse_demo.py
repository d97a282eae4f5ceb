"""All five paper structures under concurrent crashes, on the PyTorch port
— the full gauntlet.

For each structure (list, BST, hash table, skiplist, queue): run a random
concurrent workload under the NVTraverse policy, crash at a random
instruction with a random eviction subset, recover with disconnect(root),
and check durable linearizability with the Wing&Gong-style checker.

The instruction-level layer is host numpy in both packages, so this
example needs no device.

    PYTHONPATH=src python examples/torch_nvtraverse_demo.py
"""
import numpy as np

from repro_torch.core.bst import ExternalBST
from repro_torch.core.harris_list import HarrisList
from repro_torch.core.hash_table import HashTable
from repro_torch.core.linearizability import (check_durably_linearizable,
                                        check_queue_durably_linearizable,
                                        check_stack_durably_linearizable)
from repro_torch.core.pmem import PMem
from repro_torch.core.policies import get_policy
from repro_torch.core.queue import MSQueue
from repro_torch.core.scheduler import Interleaver
from repro_torch.core.skiplist import SkipList
from repro_torch.core.stack import TreiberStack
from repro_torch.core.traversal import run_operation

STRUCTURES = {
    "harris-list": lambda mem: HarrisList(mem),
    "ellen-bst": lambda mem: ExternalBST(mem),
    "hash-table": lambda mem: HashTable(mem, n_buckets=8),
    "skiplist": lambda mem: SkipList(mem),
}


def gauntlet(name, factory, trials=6):
    pol = get_policy("nvtraverse")
    passed = 0
    for seed in range(trials):
        rng = np.random.default_rng(seed)
        mem = PMem(1 << 17, seed=seed)
        ds = factory(mem)
        init = list(range(0, 16, 2))
        for k in init:
            run_operation(ds, pol, "insert", (k, k))
        mem.persist_all()
        ops = []
        for _ in range(16):
            op = rng.choice(["insert", "delete", "find"])
            k = int(rng.integers(0, 16))
            ops.append((op, (k, k) if op == "insert" else (k,)))
        il = Interleaver(ds, pol, ops, seed=seed)
        recs = il.run(crash_at=int(rng.integers(10, 200)), evict="random")
        if il.crashed:
            ds.disconnect()
            ok = check_durably_linearizable(
                recs, set(ds.contents()), initial_keys=init)
        else:
            ok = True
        passed += ok
    print(f"  {name:12s}: {passed}/{trials} crash trials durably "
          f"linearizable")
    assert passed == trials


def queue_gauntlet(trials=6):
    pol = get_policy("nvtraverse")
    passed = 0
    for seed in range(trials):
        rng = np.random.default_rng(seed)
        mem = PMem(1 << 16, seed=seed)
        q = MSQueue(mem)
        ops, v = [], 100
        for _ in range(12):
            if rng.random() < 0.6:
                ops.append(("enqueue", (v,)))
                v += 1
            else:
                ops.append(("dequeue", ()))
        il = Interleaver(q, pol, ops, seed=seed)
        recs = il.run(crash_at=int(rng.integers(5, 80)), evict="random")
        if il.crashed:
            q.disconnect()
            ok = check_queue_durably_linearizable(recs, q.contents())
        else:
            ok = True
        passed += ok
    print(f"  {'ms-queue':12s}: {passed}/{trials} crash trials durably "
          f"linearizable")
    assert passed == trials


def stack_gauntlet(trials=6):
    pol = get_policy("nvtraverse")
    passed = 0
    for seed in range(trials):
        rng = np.random.default_rng(seed)
        mem = PMem(1 << 16, seed=seed)
        st = TreiberStack(mem)
        ops, v = [], 100
        for _ in range(11):
            if rng.random() < 0.6:
                ops.append(("push", (v,)))
                v += 1
            else:
                ops.append(("pop", ()))
        il = Interleaver(st, pol, ops, seed=seed)
        recs = il.run(crash_at=int(rng.integers(5, 70)), evict="random")
        if il.crashed:
            st.disconnect()
            ok = check_stack_durably_linearizable(recs, st.contents())
        else:
            ok = True
        passed += ok
    print(f"  {'treiber-stack':12s}: {passed}/{trials} crash trials durably "
          f"linearizable")
    assert passed == trials


def main():
    print("NVTraverse demo: concurrent workloads + crashes + recovery\n")
    for name, factory in STRUCTURES.items():
        gauntlet(name, factory)
    queue_gauntlet()
    stack_gauntlet()
    print("\nall structures pass Theorem 4.2's guarantee under the "
          "interleaving/eviction adversary ✓")


if __name__ == "__main__":
    main()
