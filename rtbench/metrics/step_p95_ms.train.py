"""95th percentile of a training step's latency in the measured window,
from its start to the loss on the host (the host clock around each
make_train_step call and its loss read), in ms."""

from rtbench.harness.cell import percentile


def read(ctx):
    lat = ctx.window.latencies_ms
    return percentile(lat, 95) if len(lat) >= 20 else None
