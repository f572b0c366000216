"""Device idle ms per traced training step while the host was in the
autograd glue (`rte.autograd`: the Functions' bodies, the samples' mean
and join, the loss and `backward()`): the innermost `rte.` span open at
each idle instant (`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "autograd", "train")
