"""Prompt and generated tokens of the fresh requests served and committed
in the window, over the window's seconds (host clock, the device synced
at both ends).  Re-sent requests take their time and add no tokens."""


def read(run):
    if run["kind"] != "serve":
        return None
    tokens = sum(n * (S + run["n_new"]) for n, S in run["fresh_calls"])
    return tokens / run["window_s"]
