"""Full (generation 2) garbage collections in the window, milliseconds a
step: the program's ``gc`` spans (``Tracer.watch_gc``, which the train
step turns on) on its process-wide tracer, from the start of the
window's first ``train.step`` span to the end of its last, over the
window's steps.  Nothing where the program has no such tracer."""


def read(run):
    if run["kind"] != "train" or not run.get("steps"):
        return None
    try:
        from repro_torch.obs.spans import get_tracer
    except ImportError:
        return None
    recs = get_tracer().records()
    steps = [r for r in recs if r["span"] == "train.step"][-run["steps"]:]
    if len(steps) < run["steps"]:
        return None
    lo, hi = steps[0]["t_us"], steps[-1]["t_us"] + steps[-1]["dur_us"]
    us = sum(r["dur_us"] for r in recs if r["span"] == "gc"
             and r.get("meta", {}).get("generation") == 2
             and lo <= r["t_us"] <= hi)
    return us / run["steps"] / 1e3
