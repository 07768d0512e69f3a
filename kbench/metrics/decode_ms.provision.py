"""Milliseconds a solve spends in host decode (``last_phase_stats`` ``decode_s``; layer: decode),
summed over the window's solves and divided by their count."""

KEYS = ("decode_s",)


def read(ctx):
    if ctx.entry != "provision" or not ctx.records:
        return None
    total = sum(r["stats"].get(k, 0.0) for r in ctx.records for k in KEYS)
    return 1e3 * total / len(ctx.records)
