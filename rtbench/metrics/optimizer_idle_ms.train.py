"""Device idle ms per traced training step while the host was in the
optimizer (`rte.optimizer`: `zero_grad` and `step`): the innermost
`rte.` span open at each idle instant (`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "optimizer", "train")
