"""Reading a ``torch.profiler`` trace: the device's busy time as the union
of its operations' intervals (overlapping kernels count once), device
time by kernel name and under each of the benchmark's own ranges, and
the longest idle gaps named by what the host was doing then.

The trace is read from the profiler's own Chrome-trace export, which
its library writes without building a Python object for every event:
a traced call of a served cell holds some hundred thousand kernels.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

RANGE_PREFIX = "bench."
# the export's categories of operations on the device, and on the host
# (lower case; older exports spell some apart)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
HOST_CATS = ("cpu_op", "operator", "user_annotation", "cuda_runtime",
             "runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "runtime", "cuda_driver")


def union(intervals) -> tuple:
    """(busy length, the gaps between busy stretches) of (start, end)
    intervals."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _host_at(cpu: list, t: float) -> str:
    """The innermost host op open at time ``t`` (us): of those open then,
    the one that started last."""
    best = None
    for e in cpu:
        if e["ts"] > t:
            break
        if t <= e["ts"] + e["dur"]:
            best = e
    return best["name"] if best is not None else "host idle"


def _events(prof) -> list:
    """The trace's complete events (``"ph": "X"``), from the profiler's
    export."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = [e for e in evs if e.get("ph") == "X" and "dur" in e]
    for e in out:
        e["cat"] = str(e.get("cat", "")).lower()
    return out


class Traced:
    """``with Traced(device, host) as tr:`` profiles the block (the device
    synced at both ends); afterwards :meth:`summary` reads it.  Without
    ``host`` only the device's operations are recorded, which leaves the
    host's pace as it is untraced; with it every host op too, which the
    idle gaps are named by and the benchmark's ranges are read from."""

    def __init__(self, device, host: bool):
        self.device, self.host = device, host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts or [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        # exported at once: the next session's start clears this one's
        t0 = time.perf_counter()
        self.events = _events(self.prof)
        self.export_s = time.perf_counter() - t0
        return False

    def summary(self, top: int = 10) -> dict:
        t0 = time.perf_counter() - self.export_s
        events = self.events
        # a range's span on the device's timeline is no operation
        dev = [e for e in events if e["cat"] in DEVICE_CATS
               and not e["name"].startswith(RANGE_PREFIX)]
        if self.device.type == "cuda" and not dev:
            raise RuntimeError("no device operation in the trace; its "
                               "categories: "
                               f"{sorted({e['cat'] for e in events})}")
        out = {"window_s": self.window_s}
        if not self.host:
            busy_us, _ = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
            by_name = defaultdict(float)
            for e in dev:
                by_name[e["name"]] += e["dur"]
            ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
            out.update(busy_s=busy_us / 1e6, kernel_us=dict(by_name),
                       device_ops=[[n, us / 1e6] for n, us in ops[:top]],
                       read_s=time.perf_counter() - t0)
            return out
        cpu = sorted((e for e in events if e["cat"] in HOST_CATS),
                     key=lambda e: e["ts"])
        _, gaps = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        # a range's device time: the operations launched inside it, by
        # the launches' correlation ids
        by_corr = defaultdict(float)
        for e in dev:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] += e["dur"]
        launches = [e for e in cpu if e["cat"] in LAUNCH_CATS]
        ranges = defaultdict(float)
        for r in cpu:
            if r["name"].startswith(RANGE_PREFIX):
                a, b = r["ts"], r["ts"] + r["dur"]
                ranges[r["name"]] += sum(
                    by_corr.get(e.get("args", {}).get("correlation"), 0.0)
                    for e in launches if a <= e["ts"] <= b
                    and e.get("tid") == r.get("tid"))
        out.update(range_device_us=dict(ranges),
                   idle_gaps=[[_host_at(cpu, (a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps[:top]],
                   read_s=time.perf_counter() - t0)
        return out


def traced(device, fn, n: int, host_n: int, m: dict) -> dict:
    """``n`` calls of ``fn`` traced on the device alone (the busy time,
    each kernel's time, the launch counters' shapes), then ``host_n``
    more with the host's ops (the idle gaps' names, the ranges' device
    time); ``m`` is the configuration's ``model`` block, whose family
    names the counters."""
    from . import program
    before = program.kernel_counts(m)
    with Traced(device, host=False) as dev_only:
        for _ in range(n):
            fn()
    counts = program.counts_delta(before, program.kernel_counts(m))
    with Traced(device, host=True) as with_host:
        for _ in range(host_n):
            fn()
    a, b = dev_only.summary(), with_host.summary()
    return {"counts": counts, "calls": n, "host_calls": host_n,
            "window_s": a["window_s"], "busy_s": a["busy_s"],
            "kernel_us": a["kernel_us"],
            "range_device_us": b["range_device_us"],
            "read_s": [a["read_s"], b["read_s"]],
            "breakdown": {"device_ops": a["device_ops"],
                          "idle_gaps": b["idle_gaps"]}}
