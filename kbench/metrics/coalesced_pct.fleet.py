"""Share of the members' kernel requests answered by a batched dispatch,
in percent (layer: batching): the counts of the program's ``batch`` spans
over the window, ``batched_problems`` over the requests, which are those
plus one a solo dispatch (``dispatches`` less ``batched_dispatches``; a
failed batched dispatch counts once more). The padding share, the mean
batched size and the solo re-runs go to standard error."""
from collections import Counter

from kbench.lib import batch_spans


def read(ctx):
    if ctx.entry != "fleet":
        return None
    calls = batch_spans.grants(ctx)
    if not calls:
        return None
    c = Counter()
    for s in calls:
        c.update(s.counts or {})
    requests = (c["batched_problems"] + c["dispatches"]
                - c["batched_dispatches"])
    if not requests:
        return None
    size = c["batched_problems"] / max(c["batched_dispatches"], 1)
    pad = 100.0 * c["padded_rows"] / max(c["padded_total_rows"], 1)
    ctx.log(f"batch spans: {len(calls)} grants, {c['problems']} members,"
            f" {c['dispatches']} dispatches of which"
            f" {c['batched_dispatches']} batched, mean batched size"
            f" {size!r}, padding {pad!r}% of the batched rows, solo re-runs"
            f" {c['solo_retries']}")
    return 100.0 * c["batched_problems"] / requests
