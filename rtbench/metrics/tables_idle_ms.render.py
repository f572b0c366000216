"""Device idle ms per traced frame while the host was building the scene's
tables (`rte.tables`: `combine`, `flatten_scene`, the packing): the
innermost `rte.` span open at each idle instant (`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "tables", "render")
