"""Milliseconds a grant spends stacking its members' trees for a batched
scan and gathering their rows back (the program's spans
``dispatch.stack`` and ``dispatch.gather``; layer: batching), over the
window's grants."""
from kbench.lib import batch_spans


def read(ctx):
    if ctx.entry != "fleet":
        return None
    calls = batch_spans.grants(ctx)
    parts = batch_spans.spans(ctx, ("dispatch.stack", "dispatch.gather"))
    if not calls or parts is None:
        return None
    stack = sum(s.dt for s in parts if s.name == "dispatch.stack")
    gather = sum(s.dt for s in parts if s.name == "dispatch.gather")
    ctx.log(f"a grant: dispatch.stack {1e3 * stack / len(calls)!r} ms,"
            f" dispatch.gather {1e3 * gather / len(calls)!r} ms")
    return 1e3 * (stack + gather) / len(calls)
