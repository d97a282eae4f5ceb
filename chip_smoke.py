#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the NVTraverse map and its zamba2-7b
serving path on the card.

    python3 chip_smoke.py                 # on the card, at full size
    python3 chip_smoke.py --device cpu    # rehearsal on the host, small

Six phases, each of which fails the run when it fails:

1. ``build``  -- compile the three hand-written kernels from ``src/`` with
   nvcc, all at once, and report each compiled function's registers and
   spills (``ptxas -v``) and tensor-core instructions (``HMMA``/``HGMMA``
   in ``cuobjdump --dump-sass``); ``flash_attention`` and ``ssd_scan``
   must have some (their bf16 kernels run on ``mma.sync``), and no
   ``nvt_probe`` function may spill;
2. ``map``    -- the main path at card scale: a durable index of 2^22
   keys (2^23-node pool, 2^20 buckets) takes the repo's mixed workload
   (uniform keys in ``[1, 2*prefill)``, updates split between inserts
   and deletes, the rest lookups) at 20% and 50% updates through
   ``update_parallel``/``lookup``, is converted to 2^20 x 32 bucket tiles
   and probed with 2^20 queries through ``nvt_probe``.  Checked against a
   host dict replay (live set, ok flags, flush/fence accounting), the
   kernel against ``probe_ref`` bit for bit and against the chain lookup
   (and, on its element-load path, on the same tiles 4 bytes off a
   16-byte boundary and widened to cap 33), and ``update_parallel``
   against the ``apply`` oracle on a 4096-op batch;
3. ``serve``  -- a ``RequestLog`` whose dedup map lives on the card
   commits and evicts past its seed capacity (so ``migrate_state`` runs
   on the card), snapshots, crashes and reopens: exactly-once must hold.
   The log's spans must bill every flush and fence to its commit or
   snapshot; their times, the restart's phases and the first-call stalls
   of the growth rounds are printed;
4. ``model``  -- the serving path at full width: zamba2-7b (bf16, 81
   layers, random weights from ``--seed``) behind a ``ServeEngine`` serves
   8 requests (4 prompts of 512 tokens, 4 of 500; 16 new tokens, batches
   of 4), crashes after the first batch and is served again by a new
   engine on the same log: exactly-once must hold, and every prefill must
   launch ``flash_attention`` 13 times and ``ssd_scan`` 81 times.  Its
   prefill and decode-step times, tokens/s and peak memory are printed,
   and one profiled prefill and decode step: device time, busy share,
   the top kernels and the share of each of the port's own kernels;
5. ``checks`` -- each new kernel against its plain versions at the serve
   shapes and on the reference's sweep, and prefill (kernels) against
   prefill + one decode step (plain recurrent and attention steps) in f32
   at full width and depth 12;
6. ``timing`` -- each kernel's time (CUDA events), its plain version's,
   one PyTorch library call's where one computes the same function, and
   its bound from the bytes it must move and the operations it must do;
   ``nvt_probe`` also with L2 flushed before each launch, and in turns
   with the earlier one-warp-a-query kernel where a copy of its source
   lies at ``build/chip_scripts/nvt_probe_warp_a_query.cu``.

The last lines are the ``kernels`` JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a card (and without
``--device cpu``, which rehearses every phase but timing on small shapes
and on ``tiny(zamba2-7b)``) it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import get_arch, tiny  # noqa: E402
from repro_torch.core import batched as B  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.nvt_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.nvt_probe.ops import nvt_probe  # noqa: E402
from repro_torch.kernels.nvt_probe.ref import (  # noqa: E402
    mix32, probe_ref, tiles_from_hashmap)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref  # noqa
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs.compile import get_tracker  # noqa: E402
from repro_torch.obs.metrics import get_registry  # noqa: E402
from repro_torch.serving.engine import RequestLog, ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
KERNELS = (probe_kernel, fa_kernel, ssd_kernel)
WRAPPERS = (nvt_probe, flash_attention, ssd_scan)
TENSOR_CORE_SOURCES = ("flash_attention", "ssd_scan")
# the earlier one-warp-a-query nvt_probe, timed beside the kernel
WARP_A_QUERY_PROBE = Path(__file__).resolve().parent / "build" / \
    "chip_scripts" / "nvt_probe_warp_a_query.cu"
L2_FLUSH_BYTES = 128 << 20       # written between cold-L2 launches


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
    # model phase: zamba2-7b served through a crash and a restart
    model_tiny: bool = False     # tiny(zamba2-7b) instead of the full arch
    prompt_lens: tuple = (512, 500)   # rids 0-3, rids 4-7
    new_tokens: int = 16
    model_batch: int = 4
    # checks phase: serve shapes of the kernels, and the depth of the f32
    # prefill/decode consistency model
    check_lens: tuple = (512, 500)
    consistency_layers: int = 12


FULL = Sizes()
SMALL = Sizes(capacity=2**12, n_buckets=2**8, prefill=2**10,
              round_ops=2**9, queries=2**9, check_ops=256,
              serve_capacity=64, serve_batches=6, serve_batch=32,
              serve_retain=64, model_tiny=True, prompt_lens=(24, 20),
              new_tokens=4, check_lens=(40, 37), consistency_layers=7)


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
    found, vals = out["probe"]
    err = probe_err(out["probe"], probe_ref(kt, vt, q))
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
    element_loads = check_probe_element_loads(kt, vt, q)

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
    return {"max_abs_err": err, "element_loads": element_loads,
            "live_keys": len(want["live"]),
            "flushes": want["flushes"], "fences": want["fences"],
            "check_ops_committed": int(stats.ops_committed),
            "max_chain": int(max_chain), "mean_chain": float(mean_chain)}


def probe_err(got, want) -> int:
    """Largest difference between two ``(found, vals)`` answers."""
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(got, want))


def check_probe_element_loads(kt, vt, q) -> dict:
    """``nvt_probe`` bit for bit against ``probe_ref`` on the tiles' two
    shapes the kernel reads word by word: the same rows starting 4 bytes
    past a 16-byte boundary, and the rows widened to cap 33 (the new
    column empty, its values 5, which query 0 sums)."""
    nb, cap = kt.shape
    buf = torch.zeros((2, nb * cap + 1), dtype=torch.int32, device=kt.device)
    okt, ovt = (buf[i, 1:].view(nb, cap) for i in range(2))
    okt.copy_(kt)
    ovt.copy_(vt)
    pad = torch.nn.functional.pad
    shapes = {"offset_view": (okt, ovt),
              f"cap{cap + 1}": (pad(kt, (0, 1)), pad(vt, (0, 1), value=5))}
    errs = {}
    for name, (a, b) in shapes.items():
        errs[name] = probe_err(nvt_probe(a, b, q), probe_ref(a, b, q))
        if errs[name]:
            raise AssertionError(f"nvt_probe on {name} tiles differs from "
                                 f"probe_ref by {errs[name]}")
    return errs


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


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def model_config(sz: Sizes, **overrides):
    cfg = get_arch("zamba2-7b")
    return tiny(cfg, **overrides) if sz.model_tiny else \
        dataclasses.replace(cfg, **overrides)


def model_requests(sz: Sizes, vocab: int, seed: int) -> dict:
    """rids 0-3 with prompts of ``prompt_lens[0]`` tokens, rids 4-7 of
    ``prompt_lens[1]``, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, vocab, size=sz.prompt_lens[rid // 4])
            .astype(np.int32) for rid in range(8)}


def run_model(sz: Sizes, dev, seed: int) -> dict:
    """The slice's main path: zamba2-7b behind a ServeEngine serves 8
    requests, crashes after its first batch, and a new engine on the same
    log serves all 8 again.  Checks exactly-once, the dedup hits and the
    kernels' launch counts per prefill; returns the phase's numbers."""
    cfg = model_config(sz)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    requests = model_requests(sz, cfg.vocab, seed)
    max_len = max(sz.prompt_lens) + sz.new_tokens
    reg = get_registry()
    hits = reg.counter("serving_dedup_hits_total")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(max_len=max_len, log_dir=d, batch_size=sz.model_batch,
                  device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        first_eng = ServeEngine(model, params, **kw)
        first = first_eng.serve(requests, n_new=sz.new_tokens,
                                crash_after_batches=1)
        hits0 = hits.value
        again = ServeEngine(model, params, **kw)
        out = again.serve(requests, n_new=sz.new_tokens)
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": ssd_scan.launches,
                    "nvt_probe": nvt_probe.launches}
        dedup_hits = hits.value - hits0
        records = sorted(n for n in os.listdir(d) if n.startswith("log_"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    short = sorted(r for r in requests
                   if len(requests[r]) == min(sz.prompt_lens))
    if sorted(first) != short[:sz.model_batch]:
        raise AssertionError(f"first batch committed {sorted(first)}")
    if any(out.get(r) != first[r] for r in first):
        raise AssertionError("the first batch's results changed across "
                             "the crash")
    if sorted(out) != sorted(requests) or any(
            len(v) != sz.new_tokens or not all(0 <= t < cfg.vocab
                                               for t in v)
            for v in out.values()):
        raise AssertionError("not every request was served in full")
    if len(records) != -(-len(requests) // sz.model_batch):
        raise AssertionError(f"{len(records)} log records for "
                             f"{len(requests)} requests: not exactly once")
    if dedup_hits != len(first):
        raise AssertionError(f"the second serve counted {dedup_hits} "
                             f"dedup hits, not {len(first)}")
    prefills = len(first_eng.step_times["prefill_s"]) + \
        len(again.step_times["prefill_s"])
    n_inv = cfg.n_layers // cfg.shared_attn_every
    if dev.type == "cuda" and (
            launches["flash_attention"] != n_inv * prefills
            or launches["ssd_scan"] != cfg.n_layers * prefills):
        raise AssertionError(f"launches {launches} for {prefills} "
                             f"prefills of {cfg.n_layers} layers")
    times = {k: first_eng.step_times[k] + again.step_times[k]
             for k in first_eng.step_times}
    profiled = profile_model(model, params, requests, sz, dev) \
        if dev.type == "cuda" else None
    decode = times["decode_step_s"]
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
            "n_params": n_params, "init_s": init_s,
            "prompt_lens": list(sz.prompt_lens),
            "new_tokens": sz.new_tokens, "batch": sz.model_batch,
            "max_len": max_len, "prefills": prefills,
            "launches": launches, "dedup_hits": dedup_hits,
            "records": len(records), "prefill_s": times["prefill_s"],
            "decode_step_s_median": float(np.median(decode)),
            "decode_step_s": decode,
            "prefill_tokens_per_s": sz.model_batch * sum(sz.prompt_lens)
            / sum(times["prefill_s"]),
            "decode_tokens_per_s": sz.model_batch / float(np.median(decode)),
            "peak_bytes": peak, "profile": profiled, "reduced": []}


PORT_KERNELS = ("nvt_probe", "flash_fwd", "ssd_scan_tc", "ssd_chunk_scan")


def profile_step(fn, dev, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host-clock wall
    time (device synced), the device time of every kernel and copy it
    ran, the share of the wall the device was busy, the kernels that took
    the most device time, and the port's own kernels wherever they rank
    (``port``: each one's device time and share of the step's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
    # the kernels and copies themselves, not the host ops that launched
    # them (those carry the same device time again)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    events.sort(key=dev_us, reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "device_kernels": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in events[:top]],
            "port": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                      "calls": e.count,
                      "share": dev_us(e) / 1e3 / device_ms}
                     for e in events
                     if any(k in e.key for k in PORT_KERNELS)]}


def profile_model(model, params, requests: dict, sz: Sizes, dev) -> dict:
    """Where one prefill (the prompts of rids 0-3) and one decode step
    spend their time on the card (run after the launch counts are read)."""
    prompts = np.stack([requests[r]
                        for r in sorted(requests)[:sz.model_batch]])
    tokens = torch.as_tensor(prompts, device=dev)
    max_len = max(sz.prompt_lens) + sz.new_tokens
    out = {}
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens}, max_len)   # warm
        out["prefill"] = profile_step(lambda: model.prefill(
            params, {"tokens": tokens}, max_len), dev)
        _, caches = model.prefill(params, {"tokens": tokens}, max_len)
        S = tokens.shape[1]
        model.decode_step(params, tokens[:, -1], caches, S)  # warm
        out["decode_step"] = profile_step(lambda: model.decode_step(
            params, tokens[:, -1], caches, S + 1), dev)
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _check_close(name: str, got, want, tol: float) -> float:
    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max abs error {err} beyond {tol}")
    return err


def flash_inputs(dev, B, S, H, d, dtype, seed, K=None, Sk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    K, Sk = K or H, Sk or S
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, S, H, d), (B, Sk, K, d), (B, Sk, K, d)))


def check_flash(sz: Sizes, dev) -> dict:
    """flash_attention against attention_ref: at the serve shapes in bf16
    (reference in f32, 2e-2), and the tests/test_kernels.py sweep in f32
    (2e-5: f32 sums in another order)."""
    errs = {}
    B, H, d = 4, 32, 112
    for S in sz.check_lens:
        q, k, v = flash_inputs(dev, B, S, H, d, torch.bfloat16, S)
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True)
        errs[f"bf16_S{S}"] = _check_close(f"flash bf16 S={S}", got, want,
                                          2e-2)
    sweep = [(1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64),
             (1, 256, 256, 8, 2, 32), (2, 64, 192, 2, 1, 128)]
    for i, (B, Sq, Sk, H, K, d) in enumerate(sweep):
        q, k, v = flash_inputs(dev, B, Sq, H, d, torch.float32, i, K, Sk)
        for causal in (True, False):
            errs[f"f32_{B}x{Sq}x{Sk}x{H}x{K}x{d}_{'c' if causal else 'f'}"] \
                = _check_close("flash f32 sweep", flash_attention(
                    q, k, v, causal=causal), flash_attention_plain(
                    q, k, v, causal=causal), 2e-5)
    for window in (32, 64, 128):
        q, k, v = flash_inputs(dev, 2, 256, 4, 64, torch.float32, window)
        errs[f"f32_window{window}"] = _check_close(
            "flash f32 window", flash_attention(q, k, v, window=window),
            flash_attention_plain(q, k, v, window=window), 2e-5)
    return errs


def ssd_inputs(dev, B, S, H, P, N, dtype, seed):
    """Model-like inputs (tests/test_kernels.py's distributions)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    xh = rnd(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    return xh, dt, A, (rnd(B, S, N) * 0.5).to(dtype), \
        (rnd(B, S, N) * 0.5).to(dtype)


def check_ssd(sz: Sizes, dev) -> dict:
    """ssd_scan's y and final state at the serve shapes against the plain
    chunked version computed in f32 on the same values and against the
    sequential ssd_ref (f32 arithmetic, y rounded to the input dtype):
    bf16 at 5e-2, f32 at 1e-4.  The reference's own bf16 chunked form
    rounds its scores, partial sums and carried state to bf16 where the
    kernel keeps f32; its distance to ssd_ref is reported beside the
    kernel's (``chunked_bf16_vs_ref``), not held to the tolerance."""
    errs = {}
    B, H, P, N, Q = 4, 112, 64, 64, 128
    if sz.model_tiny:
        H, P, N, Q = 4, 16, 16, 16
    for S in sz.check_lens:
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            tag = f"{str(dtype)[6:]}_S{S}"
            xh, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, dtype, S)
            y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=Q)
            cy, cfin = ssd_chunked(xh.float(), dt, A, Bm.float(),
                                   Cm.float(), Q)
            errs[f"{tag}_y_vs_chunked"] = _check_close(
                f"ssd {tag} y", y, cy, tol)
            errs[f"{tag}_state_vs_chunked"] = _check_close(
                f"ssd {tag} state", final, cfin, tol)
            # the sequential oracle on the kernel layout (padded chunks)
            pad = (-S) % Q
            C = (S + pad) // Q

            def lay(t):
                t = torch.nn.functional.pad(
                    t, (0, 0) * (t.dim() - 2) + (0, pad))
                return t.movedim(2, 1).reshape((B * H, C, Q) + t.shape[3:])
            dtk = lay(dt)
            bc = [t[:, :, None].expand(B, S, H, N) for t in (Bm, Cm)]
            ry, rstate = ssd_ref(lay(xh), dtk, dtk * A.repeat(B)[:, None,
                                                                  None],
                                 lay(bc[0]), lay(bc[1]))
            ry = ry.reshape(B, H, C * Q, P).movedim(1, 2)[:, :S]
            errs[f"{tag}_y_vs_ref"] = _check_close(f"ssd {tag} y vs ref", y,
                                                   ry, tol)
            errs[f"{tag}_state_vs_ref"] = _check_close(
                f"ssd {tag} state vs ref", final,
                rstate.reshape(B, H, P, N), tol)
            if dtype == torch.bfloat16:
                by, bfin = ssd_chunked(xh, dt, A, Bm, Cm, Q)
                errs[f"{tag}_chunked_bf16_vs_ref"] = max_err(by, ry)
                errs[f"{tag}_chunked_bf16_vs_kernel"] = max_err(by, y)
    return errs


CONSISTENCY_TOL = 2e-3


def check_consistency(sz: Sizes, dev, seed: int) -> dict:
    """prefill(prompt[:S]) + decode_step(token S) -- the plain recurrent
    SSD step and decode attention -- against the last logits of
    prefill(prompt[:S+1]), which runs the kernels on a ragged length, in
    f32 at full width and ``consistency_layers`` deep.  Tolerance
    CONSISTENCY_TOL (abs and rel): the two sides sum in other orders
    (chunked scan against recurrence, blocked softmax against one softmax)
    and the differences grow through the layers, far below this bound in
    f32; a wrong mask, state or cache would move logits by O(1)."""
    cfg = model_config(sz, n_layers=sz.consistency_layers,
                       param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
    S = max(sz.prompt_lens)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, size=(2, S + 1)), device=dev)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :S]}, S + 1)
        dec, _ = model.decode_step(params, toks[:, S], caches, S)
        full, _ = model.prefill(params, {"tokens": toks}, S + 1)
    err = _check_close("prefill/decode consistency", dec[:, 0], full[:, 0],
                       CONSISTENCY_TOL)
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "S": S,
            "max_abs_err": err, "tol": CONSISTENCY_TOL,
            "max_abs_logit": float(full.abs().max()),
            "shared_attn_calls": cfg.n_layers // cfg.shared_attn_every}


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


def _sectors(start, nbytes):
    """The 32-byte sectors that the byte ranges ``[start, start+nbytes)``
    touch (tensors of starts, one length)."""
    return start // 32, (start + nbytes - 1) // 32


def probe_bytes(kt: torch.Tensor, vt: torch.Tensor,
                q: torch.Tensor) -> dict:
    """What the probe of ``q`` over tiles ``kt``/``vt`` must move.

    ``bytes``: each input read once -- the distinct rows the queries
    touch, the queries, the values of the hit slots (repeats included) --
    and each output written once.  ``bytes_sectors``: the same inputs at
    the card's 32-byte sector granularity, from the tensors' addresses:
    the sectors of the distinct rows, the distinct sectors that hold a
    hit slot's value, and the sectors of the queries and of the two
    outputs.  ``bytes_row_per_query``: one whole row per query, repeats
    included, as a kernel with no reuse between queries reads them."""
    nb, cap = kt.shape
    nq = q.shape[0]
    b = mix32(q) % nb
    rows = torch.unique(b)
    hit = kt[b] == q[:, None]
    hit_slots = int(hit.sum())
    need = rows.numel() * cap * 4 + nq * 4 + hit_slots * 4 + 2 * nq * 4
    per_query = nq * cap * 4 + 3 * nq * 4 + hit_slots * 4
    # the rows' sectors; a row may share its first sector with the row
    # before it where rows do not end on a sector boundary
    first, last = _sectors(kt.data_ptr() + rows * cap * 4, cap * 4)
    row_sectors = int((last - first + 1).sum()) - int(
        ((rows[1:] == rows[:-1] + 1) & (last[:-1] == first[1:])).sum())
    qi, slot = hit.nonzero(as_tuple=True)
    hit_sectors = int(torch.unique(
        (vt.data_ptr() + (b[qi] * cap + slot) * 4) // 32).numel())
    stream = sum(int(e - f + 1) for f, e in (
        _sectors(q.data_ptr(), nq * 4), _sectors(0, nq * 4),
        _sectors(0, nq * 4)))
    return {"bytes": need, "bytes_row_per_query": per_query,
            "bytes_sectors": 32 * (row_sectors + hit_sectors + stream),
            "distinct_rows": int(rows.numel()), "hit_slots": hit_slots,
            "row_sectors": row_sectors, "hit_sectors": hit_sectors}


def cuda_ms_cold_l2(fn, dev, iters: int = 20) -> float:
    """Mean time of ``fn`` on the card with L2 cold: each launch timed
    alone (CUDA events around it), after a write of L2_FLUSH_BYTES
    (over twice the 50 MB L2) that evicts what the last launch left."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (e0, e1) in enumerate(ev):
        flush.fill_(i)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def warp_a_query_probe(kt, vt, q):
    """A call of the earlier one-warp-a-query kernel (Q a multiple of 8)
    from its copy at WARP_A_QUERY_PROBE, built like the port's kernels,
    and its ``(found, vals)``; None where the copy is absent."""
    if not WARP_A_QUERY_PROBE.exists() or q.shape[0] % 8:
        return None
    (so, _), = _build.build_all([WARP_A_QUERY_PROBE])
    lib = ctypes.CDLL(str(so))
    lib.nvt_probe_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.nvt_probe_launch.restype = ctypes.c_int
    found, vals = torch.empty_like(q), torch.empty_like(q)

    def call():
        err = lib.nvt_probe_launch(
            kt.data_ptr(), vt.data_ptr(), q.data_ptr(), found.data_ptr(),
            vals.data_ptr(), kt.shape[0], kt.shape[1], q.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"warp-a-query nvt_probe launch failed: {err}")
    return call, (found, vals)


def time_probe(out: dict, launches: int, err: int) -> dict:
    """``nvt_probe`` at the map shape: back to back (CUDA events over 20
    launches) and with L2 cold, each in turns with the warp-a-query kernel
    (new, old, old, new) where its copy is present; the plain version;
    the bounds of :func:`probe_bytes` at the HBM rate."""
    kt, vt = out["tiles"]
    dev = kt.device
    q = torch.as_tensor(np.asarray(out["queries"]), device=dev)
    new = lambda: probe_kernel.nvt_probe_kernel(kt, vt, q)  # noqa: E731
    old = warp_a_query_probe(kt, vt, q)
    turns = {"ms": [], "ms_cold_l2": [], "warp_a_query_ms": [],
             "warp_a_query_ms_cold_l2": []}
    if old is not None:
        old[0]()
        if not (torch.equal(old[1][0], out["probe"][0])
                and torch.equal(old[1][1], out["probe"][1])):
            raise AssertionError("the warp-a-query kernel and nvt_probe "
                                 "disagree")
    # a longer warm-up: without it the first turn read up to 40% slow
    for fn in (new, old[0]) if old else (new,):
        cuda_ms(fn, iters=200)
    old_tag = "warp_a_query_"
    for who in ("", old_tag, old_tag, "") if old else ("", ""):
        fn = old[0] if who else new
        turns[who + "ms"].append(cuda_ms(fn))
        turns[who + "ms_cold_l2"].append(cuda_ms_cold_l2(fn, dev))
    mean = {k: sum(v) / len(v) if v else None for k, v in turns.items()}
    plain_ms = cuda_ms(lambda: probe_ref(kt, vt, q))
    nb = probe_bytes(kt, vt, q)
    bound = {k: nb[b] / HBM_BYTES_PER_S * 1e3 for k, b in (
        ("bound_ms", "bytes"), ("bound_ms_sectors", "bytes_sectors"),
        ("bound_ms_row_per_query", "bytes_row_per_query"))}
    g = probe_kernel.launch_geometry(kt.shape[1], kt.data_ptr() % 16 == 0)
    return {"name": "nvt_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/nvt_probe/csrc/nvt_probe.cu",
            "replaces": "src/repro/kernels/nvt_probe/kernel.py:48",
            "design": "batch32: 32 queries a warp, rows as 16-byte vectors, "
                      "each lane loads its own hit values, persistent grid",
            "geometry": dataclasses.asdict(g),
            "launches": launches, "max_abs_err": err, "max_abs_diff": err,
            "ms": mean["ms"], "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "ms_cold_l2": mean["ms_cold_l2"],
            "warp_a_query_ms": mean["warp_a_query_ms"],
            "warp_a_query_ms_cold_l2": mean["warp_a_query_ms_cold_l2"],
            "turns": {k: v for k, v in turns.items() if v},
            "below_bound": [k for k, v in turns.items()
                            if any(t < bound["bound_ms"] for t in v)],
            **{k: v for k, v in bound.items() if k != "bound_ms"}, **nb}


def time_flash(dev, launches: int, err: float) -> dict:
    """flash_attention at the serve shape (B=4, S=512, H=K=32, d=112,
    bf16, causal).  The bound: q, k, v read once and o written once, or
    2 * 2 * d flops per visible (query, key) pair at the bf16 peak,
    whichever is longer."""
    B, S, H, d = 4, 512, 32, 112
    q, k, v = flash_inputs(dev, B, S, H, d, torch.bfloat16, 0)
    ms = cuda_ms(lambda: fa_kernel.flash_attention_kernel(q, k, v))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * d * B * H * (S * (S + 1) // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
            "design": "mma.sync bf16", "launches": launches,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            "shape": [B, S, H, d], "dtype": "bfloat16"}


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """The chunk GEMMs the scan needs: C B^T on the lower triangle once
    per batch row and chunk (B/C are shared by the heads), and per head
    the lower-triangular scores times x, C times the carried state, and
    the state update."""
    total = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        total += B * 2 * N * tri
        total += B * H * (2 * P * tri + 2 * q * N * P + 2 * q * P * N)
    return total


def time_ssd(dev, launches: int, err: float) -> dict:
    """ssd_scan at the serve shape (B=4, S=512, H=112, P=N=64, chunk 128,
    bf16), from a zero f32 state as prefill into a cache passes it.  The
    bound: x, dt, B, C and the state read once, y and the final state
    written once, or :func:`ssd_flops` at the bf16 peak."""
    B, S, H, P, N, Q = 4, 512, 112, 64, 64, 128
    xh, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, torch.bfloat16, 0)
    init = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: ssd_kernel.ssd_scan_kernel(
        xh, dt, A, Bm, Cm, chunk=Q, init_state=init))
    plain_ms = cuda_ms(lambda: ssd_chunked(xh, dt, A, Bm, Cm, Q,
                                           init_state=init))
    nbytes = sum(t.numel() * t.element_size()
                 for t in (xh, dt, A, Bm, Cm, init)) \
        + xh.numel() * xh.element_size() + init.numel() * 4
    flops = ssd_flops(B, S, H, P, N, Q)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:34",
            "design": "mma.sync bf16", "launches": launches,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "flops": flops,
            "shape": [B, S, H, P, N, Q], "dtype": "bfloat16"}


def build_report(so: Path, ptxas: str) -> list:
    """Per compiled function of one library: registers and spill bytes
    (from the ``ptxas -v`` report) and the count of tensor-core
    instructions in its SASS (``HMMA`` from ``mma.sync``, ``HGMMA`` from
    ``wgmma``)."""
    funcs = _build.ptxas_functions(ptxas)
    for f in funcs.values():
        f["tensor_core_instr"] = 0
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(so)], capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {
                "kernel": _build.readable_name(m.group(1)),
                "registers": None, "spill_bytes": None,
                "tensor_core_instr": 0})
        elif cur is not None and re.search(r"\bH(G)?MMA\b", line):
            cur["tensor_core_instr"] += 1
    return sorted(funcs.values(), key=lambda f: f["kernel"])


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
    # every f32 check runs in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per kernel source, all started together
    if on_card:
        t0 = time.perf_counter()
        built = _build.build_all([k.SOURCE for k in KERNELS])
        build_s = time.perf_counter() - t0
        functions = {k.SOURCE.stem: build_report(so, report)
                     for k, (so, report) in zip(KERNELS, built)}
        for src in TENSOR_CORE_SOURCES:
            if not sum(f["tensor_core_instr"] for f in functions[src]):
                raise AssertionError(f"{src} has no HMMA/HGMMA instruction")
        spills = [f["kernel"] for f in functions["nvt_probe"]
                  if f["spill_bytes"]]
        if spills:
            raise AssertionError(f"nvt_probe functions spill: {spills}")
        log({"phase": "build", "ok": True,
             "kernels": [k.SOURCE.stem for k in KERNELS],
             "libraries": [so.name for so, _ in built],
             "build_s": build_s, "functions": functions})
    else:
        log({"phase": "build", "skipped": "no card: --device cpu runs "
             "the plain versions"})

    # 2. map: the map's main path, with every kernel's launch count from 0
    stream = make_stream(sz, args.seed)
    reset_launches()
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

    # 4. model: the serving path, launch counts from 0 (inside run_model)
    model = run_model(sz, dev, args.seed)
    log({"phase": "model", "ok": True, "device": str(dev), **model})

    # 5. checks: kernels against their plain versions, and consistency
    t0 = time.perf_counter()
    fa_errs = check_flash(sz, dev)
    ssd_errs = check_ssd(sz, dev)
    cons = check_consistency(sz, dev, args.seed)
    log({"phase": "checks", "ok": True, "flash_attention": fa_errs,
         "ssd_scan": ssd_errs, "consistency": cons,
         "check_s": time.perf_counter() - t0})

    # 6. timing
    if not on_card:
        log({"phase": "timing", "skipped": "no card"})
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    kern = time_probe(out, launches, checks["max_abs_err"])
    # each kernel against its plain versions at the serve shape (the
    # reference's own bf16 rounding, chunked_bf16_*, is not the kernel's)
    fa_err = fa_errs["bf16_S512"]
    ssd_err = max(v for k, v in ssd_errs.items()
                  if k.startswith("bfloat16_S512") and "chunked_bf16" not in k)
    kernels = [kern,
               time_flash(dev, model["launches"]["flash_attention"], fa_err),
               time_ssd(dev, model["launches"]["ssd_scan"], ssd_err)]
    log({"phase": "timing", "ok": True, "warm_s": warm_stages(sz, stream,
                                                             out, dev),
         "walk_step_sync_us": sync_step_us(dev),
         "max_chain": checks["max_chain"], "peak_map_bytes": peak})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
