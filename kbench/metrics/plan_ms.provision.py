"""Milliseconds a solve spends in host plan and prepare (``last_phase_stats`` ``plan_s`` + ``prepare_s``; layer: plan and prepare),
summed over the window's solves and divided by their count."""

KEYS = ("plan_s", "prepare_s")


def read(ctx):
    if ctx.entry != "provision" or not ctx.records:
        return None
    total = sum(r["stats"].get(k, 0.0) for r in ctx.records for k in KEYS)
    return 1e3 * total / len(ctx.records)
