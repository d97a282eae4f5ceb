"""The engine's prefill seconds (``ServeEngine.step_times["prefill_s"]``,
the device synced at both ends) summed over the window, per prompt token
of the window's fresh requests."""


def read(run):
    if run["kind"] != "serve" or not run["prefill_s"]:
        return None
    tokens = sum(n * S for n, S in run["fresh_calls"])
    return sum(run["prefill_s"]) / tokens * 1e6
