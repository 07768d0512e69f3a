"""Share of the traced sub-window in which no operation ran on the card,
on the fleet path (torch.profiler; layer: device). None unless the trace
holds every scan launch the port counted."""


def read(ctx):
    t = ctx.trace
    if ctx.entry != "fleet" or t is None or not t.get("complete"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
