"""Milliseconds of device time a solve's dispatches take (the program's
span ``dispatch``, its ``device_s`` from a CUDA event pair; layer:
kernel), over the window's solves. None on the CPU, where no dispatch has
device time."""
from kbench.lib import program_spans


def read(ctx):
    if ctx.entry != "provision":
        return None
    ms = program_spans.mean_ms(
        program_spans.per_request(ctx, "dispatch", "device_s"))
    program_spans.log_trace_bounds(ctx, ms)
    return ms
