"""Device idle ms per traced frame while the host was in the tonemap
(`rte.tonemap`: `tonemap` and `to_uint8`): the innermost `rte.` span
open at each idle instant (`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "tonemap", "render")
