"""Milliseconds a consolidation decision spends on the existing-node
planes and sims of its prepare (the program's spans ``prepare.nodes``;
layer: plan and prepare), over the window's decisions."""
from kbench.lib import program_spans


def read(ctx):
    if ctx.entry != "sweep":
        return None
    return program_spans.mean_ms(
        program_spans.per_request(ctx, "prepare.nodes"))
