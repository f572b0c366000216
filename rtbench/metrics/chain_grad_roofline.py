"""chain_grad's share of its roofline bound (the pullback of each bounce's
winning test; rtbench/harness/work.py), in %."""

from rtbench.harness import work


def read(ctx):
    return work.roofline_pct(ctx, "chain_grad") if ctx.kind == "train" else None
