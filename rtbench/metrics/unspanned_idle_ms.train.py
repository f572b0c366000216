"""Device idle ms per traced training step while the host was in no span of
the port: the caller's code (the loss read on the host, Python between
the port's calls): the innermost `rte.` span open at each idle instant
(`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "unspanned", "train")
