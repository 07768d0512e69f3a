"""Milliseconds a solve spends in verification (``last_phase_stats`` ``verify_s``; layer: verify),
summed over the window's solves and divided by their count."""

KEYS = ("verify_s",)


def read(ctx):
    if ctx.entry != "provision" or not ctx.records:
        return None
    total = sum(r["stats"].get(k, 0.0) for r in ctx.records for k in KEYS)
    return 1e3 * total / len(ctx.records)
