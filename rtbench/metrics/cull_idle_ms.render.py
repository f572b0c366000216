"""Device idle ms per traced frame while the host was packing the culled
tables (`rte.cull`, inside `rte.tables`: kernels/chain_trace.py::
pack_forward_tables_perm's sort, blocks and boxes): the innermost `rte.`
span open at each idle instant (`harness/spans.py`). None where the
window holds no `rte.cull` range (a program without the span)."""

from rtbench.harness import spans


def read(ctx):
    if not any(name == "rte.cull" for name, _, _ in ctx.trace.host):
        return None
    return spans.idle_ms(ctx, "cull", "render")
