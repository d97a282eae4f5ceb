"""The attention kernels (the forward, its recompute, the backward pair)
against their bound: the frozen work formula's least time at every
counted call's shape, over the profiled device time of the port's
attention kernels."""
from bench.harness.rooflines import flash as _flash


def read(run):
    return _flash(run) if run["kind"] == "train" else None
