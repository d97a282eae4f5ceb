"""The median of the engine's decode-step seconds in the window
(``ServeEngine.step_times["decode_step_s"]``)."""
import statistics


def read(run):
    if run["kind"] != "serve" or not run["decode_step_s"]:
        return None
    return statistics.median(run["decode_step_s"]) * 1e3
