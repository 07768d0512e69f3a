"""Milliseconds a consolidation decision spends building its sweep problem
on the host (the program's span ``sweep.problem``: the scheduler, the
prepare and the prefix batches; layer: consolidation sweep), over the
window's decisions."""
from kbench.lib import program_spans


def read(ctx):
    if ctx.entry != "sweep":
        return None
    program_spans.log_children(ctx, "sweep.problem")
    return program_spans.mean_ms(
        program_spans.per_request(ctx, "sweep.problem"))
