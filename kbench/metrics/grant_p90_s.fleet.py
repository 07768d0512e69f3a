"""Wall seconds of a grant at the 90th percentile: the benchmark's clock
around every ``solve_batch`` of the window (the layer of
``solve_p90_s.provision``)."""
from kbench.lib.stats import p90, tail_line


def read(ctx):
    if ctx.entry != "fleet":
        return None
    times = [r["dt"] for r in ctx.records]
    ctx.log(tail_line("grant seconds", times))
    return p90(times)
