"""Device idle ms per traced frame while the host was in a kernel wrapper
(`rte.launch.<kernel>`: its checks, buffers and launch): the innermost
`rte.` span open at each idle instant (`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "launch", "render")
