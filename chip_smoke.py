#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the NVTraverse map on the card.

    python3 chip_smoke.py                 # on the card, at full size
    python3 chip_smoke.py --device cpu    # rehearsal on the host, small

Four phases, each of which fails the run when it fails:

1. ``build``  -- compile the hand-written kernels from ``src/`` with nvcc
   and print their register/spill report;
2. ``map``    -- the main path at card scale: a durable index of 2^22
   keys (2^23-node pool, 2^20 buckets) takes the repo's mixed workload
   (uniform keys in ``[1, 2*prefill)``, updates split between inserts
   and deletes, the rest lookups) at 20% and 50% updates through
   ``update_parallel``/``lookup``, is converted to 2^20 x 32 bucket tiles
   and probed with 2^20 queries through ``nvt_probe``.  Checked against a
   host dict replay (live set, ok flags, flush/fence accounting), the
   kernel against ``probe_ref`` bit for bit and against the chain lookup,
   and ``update_parallel`` against the ``apply`` oracle on a 4096-op batch;
3. ``serve``  -- a ``RequestLog`` whose dedup map lives on the card
   commits and evicts past its seed capacity (so ``migrate_state`` runs
   on the card), snapshots, crashes and reopens: exactly-once must hold.
   The log's spans must bill every flush and fence to its commit or
   snapshot; their times, the restart's phases and the first-call stalls
   of the growth rounds are printed;
4. ``timing`` -- each kernel's time (CUDA events), its plain version's,
   and its bound from the bytes it must move.

The last lines are the ``kernels`` JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a card (and without
``--device cpu``) it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import batched as B  # noqa: E402
from repro_torch.kernels.nvt_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.nvt_probe.ops import nvt_probe  # noqa: E402
from repro_torch.kernels.nvt_probe.ref import (  # noqa: E402
    mix32, probe_ref, tiles_from_hashmap)
from repro_torch.obs.compile import get_tracker  # noqa: E402
from repro_torch.obs.metrics import get_registry  # noqa: E402
from repro_torch.serving.engine import RequestLog  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate


@dataclasses.dataclass(frozen=True)
class Sizes:
    capacity: int = 2**23        # node pool
    n_buckets: int = 2**20
    prefill: int = 2**22
    round_ops: int = 2**20       # ops per mixed round
    ratios: tuple = (20, 50)     # update percentage of each round
    queries: int = 2**20         # nvt_probe queries
    cap: int = 32                # tile row width
    check_ops: int = 4096        # update_parallel vs apply batch
    serve_capacity: int = 1 << 15
    serve_batches: int = 40
    serve_batch: int = 1024
    serve_retain: int = 8192


FULL = Sizes()
SMALL = Sizes(capacity=2**12, n_buckets=2**8, prefill=2**10,
              round_ops=2**9, queries=2**9, check_ops=256,
              serve_capacity=64, serve_batches=6, serve_batch=32,
              serve_retain=64)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_stream(sz: Sizes, seed: int = 1) -> dict:
    """The map phase's whole input, from one seed, as numpy int32."""
    rng = np.random.default_rng(seed)
    pre = np.arange(1, sz.prefill + 1, dtype=np.int32)
    rounds = []
    for ratio in sz.ratios:
        n_upd = sz.round_ops * ratio // 100
        ops = rng.integers(0, 2, size=n_upd).astype(np.int32)
        ks = rng.integers(1, 2 * sz.prefill, size=n_upd).astype(np.int32)
        look = rng.integers(1, 2 * sz.prefill,
                            size=sz.round_ops - n_upd).astype(np.int32)
        rounds.append((ops, ks, ks * 3, look))
    queries = rng.integers(1, 2 * sz.prefill, size=sz.queries).astype(
        np.int32)
    queries[:2] = (0, -1)        # the empty-slot and padding keys
    check = (rng.integers(0, 2, size=sz.check_ops).astype(np.int32),
             rng.integers(1, sz.check_ops // 2,
                          size=sz.check_ops).astype(np.int32),
             rng.integers(0, 1 << 20, size=sz.check_ops).astype(np.int32))
    return {"prefill": pre, "rounds": rounds, "queries": queries,
            "check": check}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_map(sz: Sizes, stream: dict, device) -> dict:
    """The main path, timed per stage on the host clock (each stage ends
    in a device sync).  Returns every result the checks read."""
    dev = B.resolve_device(device)
    times, out = {}, {"ok": [], "lookups": []}

    def stage(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return r

    st = stage("make_state", lambda: B.make_state(sz.capacity, sz.n_buckets,
                                                  dev))
    pre = torch.as_tensor(stream["prefill"], device=dev)
    st, ok, _ = stage("prefill", lambda: B.update_parallel(
        st, torch.zeros_like(pre), pre, pre, sz.n_buckets))
    out["prefill_ok"] = ok
    for ratio, (ops, ks, vs, look) in zip(sz.ratios, stream["rounds"]):
        st, ok, _ = stage(f"update_{ratio}", lambda: B.update_parallel(
            st, torch.as_tensor(ops, device=dev),
            torch.as_tensor(ks, device=dev),
            torch.as_tensor(vs, device=dev), sz.n_buckets))
        out["ok"].append(ok)
        out["lookups"].append(stage(f"lookup_{ratio}", lambda: B.lookup(
            st, torch.as_tensor(look, device=dev), sz.n_buckets)))
    out["state"] = st
    out["tiles"] = stage("tiles", lambda: tiles_from_hashmap(
        st, sz.n_buckets, sz.cap))
    q = torch.as_tensor(stream["queries"], device=dev)
    out["probe"] = stage("probe", lambda: nvt_probe(*out["tiles"], q))
    out["times"] = times
    return out


def replay(sz: Sizes, stream: dict) -> dict:
    """Host dict replay of the map phase's op stream (independent of the
    engine): per-op ok flags, flush/fence totals, the lookups and the
    final live key -> value set."""
    node = {}                    # key -> [live, val] for keys with a node
    flushes = fences = 0

    def run(ops, ks, vs):
        nonlocal flushes, fences
        ok = np.zeros(len(ks), np.bool_)
        for i, (op, k, v) in enumerate(zip(ops.tolist(), ks.tolist(),
                                           vs.tolist())):
            cell = node.get(k)
            if op == B.OP_INSERT:
                if cell is None:
                    node[k] = [True, v]
                    flushes += 2
                elif not cell[0]:
                    cell[0], cell[1] = True, v
                    flushes += 1
                else:
                    continue
            elif cell is not None and cell[0]:
                cell[0] = False
                flushes += 1
            else:
                continue
            fences += 2
            ok[i] = True
        return ok

    pre = stream["prefill"]
    res = {"prefill_ok": run(np.zeros_like(pre), pre, pre), "ok": [],
           "lookups": []}
    for ops, ks, vs, look in stream["rounds"]:
        res["ok"].append(run(ops, ks, vs))
        cells = [node.get(k) for k in look.tolist()]
        found = np.array([c is not None and c[0] for c in cells], np.bool_)
        vals = np.array([c[1] if c is not None and c[0] else 0
                         for c in cells], np.int32)
        res["lookups"].append((found, vals))
    res["live"] = {k: c[1] for k, c in node.items() if c[0]}
    res["flushes"], res["fences"] = flushes, fences
    return res


def check_map(sz: Sizes, stream: dict, out: dict) -> dict:
    """Every check of the map phase; raises on the first failure."""
    want = replay(sz, stream)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if not np.array_equal(host(out["prefill_ok"]), want["prefill_ok"]):
        raise AssertionError("prefill ok flags differ from the replay")
    for i, ratio in enumerate(sz.ratios):
        if not np.array_equal(host(out["ok"][i]), want["ok"][i]):
            raise AssertionError(f"round {ratio}%: ok flags differ")
        for got, exp in zip(out["lookups"][i], want["lookups"][i]):
            if not np.array_equal(host(got), exp):
                raise AssertionError(f"round {ratio}%: lookups differ")
    st = B.state_to_numpy(out["state"])
    if (int(st["flushes"]), int(st["fences"])) != (want["flushes"],
                                                   want["fences"]):
        raise AssertionError("flush/fence accounting differs")
    c = int(st["cursor"])
    live = st["live"][1:c]
    got = dict(zip(st["key"][1:c][live].tolist(),
                   st["val"][1:c][live].tolist()))
    if got != want["live"] or int(live.sum()) != len(want["live"]):
        raise AssertionError("final live set differs from the replay")

    # the kernel: bit for bit against its plain version on the same inputs
    kt, vt = out["tiles"]
    q = torch.as_tensor(stream["queries"], device=kt.device)
    ref_found, ref_vals = probe_ref(kt, vt, q)
    found, vals = out["probe"]
    err = max(int((found - ref_found).abs().max()),
              int((vals.long() - ref_vals.long()).abs().max()))
    if err:
        raise AssertionError(f"nvt_probe differs from probe_ref by {err}")
    # ... and consistent with the chain walk (query 0 "finds" any bucket
    # with an empty slot in the tile layout, by design)
    cf, cv = B.lookup(out["state"], q, sz.n_buckets)
    real = q != 0
    f = found.bool()
    if not (torch.equal(f[real], cf[real]) and torch.equal(
            (vals * f)[real], (cv * cf)[real])):
        raise AssertionError("nvt_probe disagrees with the chain lookup")

    # the plan/commit engine against the sequential oracle, field by field
    ops, ks, vs = (torch.as_tensor(a, device=kt.device)
                   for a in stream["check"])
    st_p, ok_p, stats = B.update_parallel(out["state"], ops, ks, vs,
                                          sz.n_buckets)
    st_o, ok_o = B.apply(out["state"], ops, ks, vs, sz.n_buckets)
    if not torch.equal(ok_p, ok_o):
        raise AssertionError("update_parallel ok flags differ from apply")
    for fld in B.HashMapState._fields:
        if not torch.equal(getattr(st_p, fld), getattr(st_o, fld)):
            raise AssertionError(f"update_parallel field {fld} differs "
                                 f"from apply")
    max_chain, mean_chain = B.chain_stats(out["state"], sz.n_buckets)
    return {"max_abs_err": err, "live_keys": len(want["live"]),
            "flushes": want["flushes"], "fences": want["fences"],
            "check_ops_committed": int(stats.ops_committed),
            "max_chain": int(max_chain), "mean_chain": float(mean_chain)}


def run_serve(sz: Sizes, device) -> dict:
    """Exactly-once across growth, snapshot, crash and restart, with what
    the log's own instrumentation saw (:func:`serve_trace`)."""
    dev = B.resolve_device(device)
    get_registry().reset()
    get_tracker().reset()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rlog = RequestLog(d, capacity=sz.serve_capacity, device=dev)
        rid = 0
        for _ in range(sz.serve_batches):
            batch = {r: [r, (r * 7) % 1000]
                     for r in range(rid, rid + sz.serve_batch)}
            rlog.commit(batch, evict=rlog.expired_rids(sz.serve_retain))
            rid += sz.serve_batch
        if rlog.dedup_migrations < 1:
            raise AssertionError("the dedup map never grew")
        rlog.snapshot()
        rlog.commit({rid: [rid, 0]},
                    evict=rlog.expired_rids(sz.serve_retain))
        rid += 1
        before = rlog.committed()
        kept = sorted(before)
        evicted = sorted(set(range(rid)) - set(before))
        if not evicted:
            raise AssertionError("nothing was evicted")
        rlog.io.crash()
        t1 = time.perf_counter()
        again = RequestLog(d, capacity=sz.serve_capacity, device=dev)
        t2 = time.perf_counter()
        if again.committed() != before:
            raise AssertionError("committed() changed across the crash")
        if not again.took_effect(kept).all():
            raise AssertionError("a kept rid lost its effect")
        if again.took_effect(evicted).any():
            raise AssertionError("an evicted rid took effect")
        if again.records_parsed != 1:
            raise AssertionError("restart replayed more than the suffix")
        return {"rids": rid, "kept": len(kept), "evicted": len(evicted),
                "dedup_migrations": rlog.dedup_migrations,
                "commit_s": t1 - t0, "restart_s": t2 - t1,
                **serve_trace(rlog, again, sz.serve_batches + 1, 1)}


def serve_trace(rlog, again, n_commits: int, n_snaps: int) -> dict:
    """Read the request log's spans, counters and first-call events, and
    check them against the flush -> fence -> publish discipline: each
    commit stages one record outside its flush/fence, every flush and
    fence falls inside a ``flush_fence`` span (one of each per commit
    and per snapshot), the snapshot publishes once, and the tracer's
    totals equal ``StagedIO``'s own counters."""
    reg = get_registry()
    n, bill = {}, {}
    for r in rlog.tracer.records():
        n[r["span"]] = n.get(r["span"], 0) + 1
        b = bill.setdefault(r["span"], {})
        for k, c in r["counts"].items():
            b[k] = b.get(k, 0) + c
    want = {"commit": {"write": n_commits},
            "flush_fence": {"flush": n_commits + n_snaps,
                            "fence": n_commits + n_snaps},
            "publish": {"publish": n_snaps}}
    for phase, counts in want.items():
        if bill.get(phase) != counts:
            raise AssertionError(f"span {phase!r} bill {bill.get(phase)} "
                                 f"!= {counts}")
    if bill["snapshot"].get("write") != n_snaps or {"flush", "fence"} & \
            set(bill["snapshot"]):
        raise AssertionError(f"snapshot span bill {bill['snapshot']}")
    io = rlog.io.counters
    if (rlog.tracer.totals.get("flush"), rlog.tracer.totals.get("fence")) \
            != (io.flushes, io.fences):
        raise AssertionError("span totals disagree with StagedIO counters")
    counters = {e.name + ("{%s}" % ",".join(
        f"{k}={v}" for k, v in sorted(e.labels.items())) if e.labels
        else ""): e.obj.value for e in reg.entries() if e.kind == "counter"}
    if counters.get("serving_commits_total") != n_commits or \
            counters.get("dedup_migrations_total") != \
            rlog.dedup_migrations + again.dedup_migrations:
        raise AssertionError(f"registry counters {counters}")
    first = get_tracker().stats()
    if first.get("capacity_ladder", {}).get("events", 0) < 1:
        raise AssertionError("no first-call event on the capacity ladder")
    span_us = {ph: {"n": n[ph], **{q: reg.histogram(
        "span_us", lo=0.1, hi=1e8, growth=1.25, phase=ph).quantile(v)
        for q, v in (("p50", 0.5), ("p99", 0.99))}} for ph in sorted(n)}
    return {"span_us": span_us, "span_bill": bill,
            "restart_phase_us": again.restart_timing,
            "counters": counters, "first_calls": first}


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def sync_step_us(dev, iters: int = 200) -> float:
    """Host time of one chain-walk step's control round trip: a tiny
    reduction on the card read back by the host."""
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    bool((x != 0).any())
    t0 = time.perf_counter()
    for _ in range(iters):
        bool((x != 0).any())
    return (time.perf_counter() - t0) / iters * 1e6


def warm_stages(sz: Sizes, stream: dict, out: dict, dev) -> dict:
    """Host-clock seconds of the main path's map stages run again, warm
    (the first run also pays for loading PyTorch's CUDA modules)."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    pre = torch.as_tensor(stream["prefill"], device=dev)
    fresh = B.make_state(sz.capacity, sz.n_buckets, dev)
    ops, ks, vs, look = (torch.as_tensor(a, device=dev)
                         for a in stream["rounds"][-1])
    q = torch.as_tensor(stream["queries"], device=dev)
    st = out["state"]
    return {
        "prefill": timed(lambda: B.update_parallel(
            fresh, torch.zeros_like(pre), pre, pre, sz.n_buckets)),
        f"update_{sz.ratios[-1]}": timed(lambda: B.update_parallel(
            st, ops, ks, vs, sz.n_buckets)),
        f"lookup_{sz.ratios[-1]}": timed(lambda: B.lookup(st, look,
                                                          sz.n_buckets)),
        "tiles": timed(lambda: tiles_from_hashmap(st, sz.n_buckets, sz.cap)),
        "probe": timed(lambda: nvt_probe(*out["tiles"], q)),
    }


def time_probe(sz: Sizes, out: dict, launches: int, err: int) -> dict:
    kt, vt = out["tiles"]
    q = torch.as_tensor(np.asarray(out["queries"]), device=kt.device)
    nq = q.shape[0]
    ms = cuda_ms(lambda: probe_kernel.nvt_probe_kernel(kt, vt, q))
    plain_ms = cuda_ms(lambda: probe_ref(kt, vt, q))
    b = mix32(q) % sz.n_buckets
    rows = int(torch.unique(b).numel())
    hit_slots = int((kt[b] == q[:, None]).sum())
    # each input read once: the distinct rows the queries touch, the
    # queries, the values of hit slots; each output written once
    need = rows * sz.cap * 4 + nq * 4 + hit_slots * 4 + 2 * nq * 4
    per_query = nq * sz.cap * 4 + 3 * nq * 4 + hit_slots * 4
    return {"name": "nvt_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/nvt_probe/csrc/nvt_probe.cu",
            "replaces": "src/repro/kernels/nvt_probe/kernel.py:48",
            "launches": launches, "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "bytes": need, "distinct_rows": rows,
            "hit_slots": hit_slots,
            "bound_ms_row_per_query": per_query / HBM_BYTES_PER_S * 1e3}


def card_name_and_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (use --device cpu to rehearse "
              "on the host)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    sz = FULL if on_card else SMALL

    # 1. build
    if on_card:
        t0 = time.perf_counter()
        so, report = probe_kernel.build()
        print(report.strip(), flush=True)
        log({"phase": "build", "ok": True, "kernels": ["nvt_probe"],
             "library": so.name, "build_s": time.perf_counter() - t0})
    else:
        log({"phase": "build", "skipped": "no card: --device cpu runs "
             "the plain versions"})

    # 2. map: the main path, with every kernel's launch count from 0
    stream = make_stream(sz, args.seed)
    nvt_probe.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = run_map(sz, stream, dev)
    launches = nvt_probe.launches
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if on_card and launches == 0:
        raise AssertionError("the main path never launched nvt_probe")
    out["queries"] = stream["queries"]
    t0 = time.perf_counter()
    checks = check_map(sz, stream, out)
    log({"phase": "map", "ok": True, "device": str(dev),
         "sizes": dataclasses.asdict(sz), "stage_s": out["times"],
         "check_s": time.perf_counter() - t0, "launches": launches,
         **checks})

    # 3. serve
    log({"phase": "serve", "ok": True, **run_serve(sz, dev)})

    # 4. timing
    if not on_card:
        log({"phase": "timing", "skipped": "no card"})
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    kern = time_probe(sz, out, launches, checks["max_abs_err"])
    log({"phase": "timing", "ok": True, "warm_s": warm_stages(sz, stream,
                                                             out, dev),
         "walk_step_sync_us": sync_step_us(dev),
         "max_chain": checks["max_chain"], "peak_map_bytes": peak})
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(card_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
