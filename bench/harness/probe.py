"""What the host and the allocator did while the window ran, for telling
a slow run's cause: the pauses of Python's garbage collector, the
process's CPU seconds (every thread's) and the CUDA caching allocator's
device allocations, frees and retries.  Read into the run's readings on
standard error; no metric is taken from them."""
from __future__ import annotations

import gc
import time

import torch

ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


class Probe:
    def __init__(self, device):
        self.device = device
        self.pauses: list = []          # (generation, seconds)
        self._t = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def _alloc(self) -> dict:
        if self.device.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(self.device)
        return {k: st.get(k, 0) for k in ALLOC_KEYS}

    def __enter__(self):
        self.a0, self.cpu0 = self._alloc(), time.process_time()
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.cpu_s = time.process_time() - self.cpu0
        a1 = self._alloc()
        self.alloc = {k: a1[k] - self.a0[k] for k in a1}
        return False

    def readings(self) -> dict:
        full = [s for g, s in self.pauses if g == 2]
        return {"cpu_s": self.cpu_s, "gc_pauses": len(self.pauses),
                "gc_s": sum(s for _, s in self.pauses),
                "gc2_s": sum(full), "gc2_max_s": max(full, default=0.0),
                **{"alloc_" + k[4:]: v for k, v in self.alloc.items()}}
