"""Milliseconds of device time a grant's dispatches take, batched and solo
(the program's spans ``dispatch``, their ``device_s`` from a CUDA event
pair; layer: kernel), over the window's grants. None on the CPU."""
from kbench.lib import batch_spans, program_spans


def read(ctx):
    if ctx.entry != "fleet":
        return None
    found = batch_spans.spans(ctx, ("dispatch",))
    timed = [s.counts["device_s"] for s in found or ()
             if s.counts and "device_s" in s.counts]
    if not timed:
        return None
    ms = 1e3 * sum(timed) / len(ctx.records)
    program_spans.log_trace_bounds(ctx, ms)
    return ms
