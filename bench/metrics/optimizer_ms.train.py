"""Device time a step of the kernels launched under the ``bench.optimizer``
profiler range the benchmark puts around AdamW's update, over the steps
traced with the host's ops."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t:
        return None
    us = t["range_device_us"].get("bench.optimizer", 0.0)
    return us / t["host_calls"] / 1e3 if us > 0 else None
