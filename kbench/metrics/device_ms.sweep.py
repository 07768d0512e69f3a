"""Milliseconds of device time a consolidation decision's prefix scans
take, with their reductions (the program's spans ``sweep.scan``, their
``device_s`` from a CUDA event pair; layer: kernel), over the window's
decisions. None on the CPU."""
from kbench.lib import program_spans


def read(ctx):
    if ctx.entry != "sweep":
        return None
    ms = program_spans.mean_ms(
        program_spans.per_request(ctx, "sweep.scan", "device_s"))
    program_spans.log_trace_bounds(ctx, ms)
    return ms
