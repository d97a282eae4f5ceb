"""The SSD scan's kernels (forward and backward) against their bound: the
frozen work formula's least time at every counted call's shape, over the
profiled device time of the port's SSD kernels."""
from bench.harness.rooflines import ssd as _ssd


def read(run):
    return _ssd(run) if run["kind"] == "train" else None
