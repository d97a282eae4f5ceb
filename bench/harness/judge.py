"""The comparison that decides ``correct``: the numbers compared and
their limits (the limits live in each configuration's file, set from
readings of sound runs and of the control)."""
from __future__ import annotations

import statistics


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """``|prog - ref| / max(ref, median ref)`` of each leaf: the gap of
    two norms, against the reference's norm of the leaf or of the median
    leaf."""
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    out = {}
    for n in leaves:
        den = max(ref[n], med)
        out[n] = abs(prog[n] - ref[n]) / den if den > 0 \
            else float(prog[n] != 0)
    return out


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> tuple:
    """The largest of :func:`leaf_gaps` and the leaf that gives it."""
    gaps = leaf_gaps(prog, ref, leaves)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the widest relative gap of a step's loss;
    ``grad_gap``: the worst leaf's gap of the first gradient's norm, as
    AdamW takes it (before its clipping), and ``grad_gap_median`` the
    median leaf's (steady where a few small leaves swing the worst);
    ``change_gap``: the worst leaf's
    gap of the change's norm over the steps, among leaves whose reference
    gradient is above a thousandth of the median leaf's."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"],
                      ref["first_grad"])
    grad_at = max(grads, key=grads.get)
    med = statistics.median(ref["first_grad"].values())
    moved = [n for n, g in ref["first_grad"].items() if g >= 1e-3 * med]
    change_gap, change_at = worst_leaf_gap(prog["change"], ref["change"],
                                           moved)
    left_out = sorted(set(ref["first_grad"]) - set(moved))
    return {"loss_gap": loss_gap, "grad_gap": grads[grad_at],
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap": change_gap,
            "_where": {"grad_gap": grad_at, "change_gap": change_at,
                       "left_out": left_out}}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; ``checks``
    is ``{name: {"value", "limit"}}`` in the limits' order."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
