"""Tokens of every train step completed in the window, over the window's
seconds (host clock, the device synced at both ends)."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["steps"] * run["batch"] * run["seq"] / run["window_s"]
