"""Share of the traced part of the window with no operation on the device:
the union of the device operations' intervals, so overlapping kernels
count once (not a sum of kernel times)."""
from bench.harness.rooflines import idle_share


def read(run):
    return idle_share(run) if run["kind"] == "train" else None
