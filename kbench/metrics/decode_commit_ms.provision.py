"""Milliseconds a solve spends in decode's bulk commits (the program's
span ``decode.commit``; layer: decode), over the window's solves. The
fresh slots it committed and the instance types its refit tested, a solve,
go to standard error."""
from kbench.lib import program_spans


def read(ctx):
    if ctx.entry != "provision":
        return None
    ms = program_spans.mean_ms(program_spans.per_request(ctx, "decode.commit"))
    if ms is None:
        return None
    for key in ("fresh_slots", "types_tested"):
        counts = program_spans.per_request(ctx, "decode.commit", key)
        if counts:
            ctx.log(f"decode.commit {key} a solve: mean"
                    f" {sum(counts) / len(counts)!r} over {len(counts)}"
                    f" solves (min {min(counts)!r}, max {max(counts)!r})")
    program_spans.log_children(ctx, "decode")
    return ms
