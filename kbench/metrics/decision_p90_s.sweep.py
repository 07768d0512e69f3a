"""Wall seconds of a consolidation decision at the 90th percentile: the
benchmark's clock around every ``frontier_core`` of the window (layer:
consolidation sweep)."""
from kbench.lib.stats import p90, tail_line


def read(ctx):
    if ctx.entry != "sweep":
        return None
    times = [r["dt"] for r in ctx.records]
    ctx.log(tail_line("decision seconds", times))
    return p90(times)
