"""chain_trace's share of its roofline bound in a render cell's frames of
the compared pose (rtbench/harness/work.py), in %."""

from rtbench.harness import work


def read(ctx):
    return work.roofline_pct(ctx, "chain_trace") if ctx.kind == "render" else None
