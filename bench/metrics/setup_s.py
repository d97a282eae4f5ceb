"""Seconds from the process's start to the first timed step or call:
imports, loading (or, in a fresh checkout, building) the kernels, the
weights, the warm-up."""


def read(run):
    return run["setup_s"]
