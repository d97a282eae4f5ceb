"""The attention kernels (the prefill forward)
against their bound: the frozen work formula's least time at every
counted call's shape, over the profiled device time of the port's
attention kernels."""
from bench.harness.rooflines import flash as _flash


def read(run):
    return _flash(run) if run["kind"] == "serve" else None
