"""The median wall time of the window's train steps, each from one step's
loss read to the next's (host clock).  Beside ``train_tokens_per_s``,
which takes all the window's work over all its time, the median is
steadier against a host that stalls now and then."""
import statistics


def read(run):
    if run["kind"] != "train" or not run["parts"].get("step_s"):
        return None
    return statistics.median(run["parts"]["step_s"]) * 1e3
