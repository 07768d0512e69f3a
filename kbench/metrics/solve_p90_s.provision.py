"""Wall seconds of a solve at the 90th percentile: the benchmark's clock
around every ``DeviceScheduler.solve`` of the window (layer: solve
driver)."""
from kbench.lib.stats import p90, tail_line


def read(ctx):
    if ctx.entry != "provision":
        return None
    times = [r["dt"] for r in ctx.records]
    ctx.log(tail_line("solve seconds", times))
    return p90(times)
