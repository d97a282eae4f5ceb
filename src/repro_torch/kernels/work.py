"""The work a kernel's meta-device branch stands for.

On the meta device (the dry-run's cells, :mod:`repro_torch.launch.cells`)
a kernel wrapper computes nothing and launches nothing: it returns empty
outputs of the kernel's shapes and dtypes and adds the kernel's work, by
its formula (``work`` beside each kernel), to every :class:`Tally` that is
recording.  The formulas count what the kernel must do whatever
implements it: 2 flops a multiply-add of each product it needs, and each
input read once and each output written once.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import List

_ACTIVE: List["Tally"] = []


class Tally:
    """Flops and bytes of the kernels' meta branches, in all and by
    kernel name."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_kernel = defaultdict(lambda: {"calls": 0, "flops": 0,
                                              "bytes": 0})

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        k = self.by_kernel[name]
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)


def add(name: str, flops: int, nbytes: int) -> None:
    """Add one kernel call's work to every recording tally."""
    for t in _ACTIVE:
        t.add(name, flops, nbytes)


@contextlib.contextmanager
def recording(tally: Tally):
    _ACTIVE.append(tally)
    try:
        yield tally
    finally:
        _ACTIVE.remove(tally)
