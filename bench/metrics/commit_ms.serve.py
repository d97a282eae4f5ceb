"""The median of the request log's own ``commit`` span in the window
(``RequestLog.commit``: the record written, flushed and fenced, the
dedup map updated)."""
import statistics


def read(run):
    if run["kind"] != "serve" or not run["commit_us"]:
        return None
    return statistics.median(run["commit_us"]) / 1e3
