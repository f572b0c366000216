"""The taping chain_trace's share of its roofline bound in a training
step (rtbench/harness/work.py: the bound of the step's forward tests over
the kernel's device time), in %."""

from rtbench.harness import work


def read(ctx):
    return work.roofline_pct(ctx, "chain_trace") if ctx.kind == "train" else None
