"""The arithmetic the kernel and device metrics share: a kernel family's
share of its roofline over the traced part of the window, and the
device's idle share there."""
from __future__ import annotations

from . import yardstick as Y

# substrings of the port's kernel names, as the profiler shows them
FLASH_KERNELS = ("flash_fwd", "flash_bwd")
SSD_KERNELS = ("ssd_fwd", "ssd_bwd", "ssd_scan", "ssd_chunk")


def _device_s(trace: dict, names) -> float:
    return sum(us for k, us in trace["kernel_us"].items()
               if any(n in k for n in names)) / 1e6


def _share(trace: dict, bound: float, names, what: str):
    if bound == 0:
        return None
    busy = _device_s(trace, names)
    if busy == 0:
        raise RuntimeError(f"{what} calls were counted, but no kernel in the "
                           f"trace matched {names}")
    return bound / busy * 100


def flash(run: dict):
    t = run.get("trace")
    if not t:
        return None
    with_lse = run["kind"] == "train"
    bound = 0.0
    for bwd in (False, True):
        for (B, Sq, Sk, H, K, d, causal, window), n in \
                t["counts"].get("flash_bwd" if bwd else "flash_fwd",
                                {}).items():
            bound += n * Y.bound_s(Y.flash_work(
                B, Sq, Sk, H, K, d, causal=causal, window=window,
                backward=bwd, with_lse=with_lse and not bwd))
    return _share(t, bound, FLASH_KERNELS, "attention")


def ssd(run: dict):
    t = run.get("trace")
    if not t:
        return None
    train = run["kind"] == "train"
    bound = 0.0
    for bwd in (False, True):
        for (B, S, H, P, N, chunk), n in \
                t["counts"].get("ssd_bwd" if bwd else "ssd_fwd",
                                {}).items():
            bound += n * Y.bound_s(Y.ssd_work(
                B, S, H, P, N, chunk, backward=bwd,
                with_states=train and not bwd, init_state=not train))
    return _share(t, bound, SSD_KERNELS, "SSD")


def idle_share(run: dict):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
