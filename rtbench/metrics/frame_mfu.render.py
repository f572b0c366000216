"""The whole frame's share of the card's fp32 peak, in %: the counted
operations of a frame of the compared frame's pose (`harness/work.py`)
times the measured window's frames of that pose, over the host clock's
sum of their latencies times the peak. Each frame ends with its image on
the host, so its latency is the whole frame."""

from rtbench.harness import work


def read(ctx):
    if ctx.peak is None or ctx.kind != "render":
        return None
    ms = [t for t, pose in zip(ctx.window.latencies_ms, ctx.window.poses)
          if pose == ctx.compared_pose]
    if not ms:
        return None
    return 100.0 * work.step_ops(ctx) * len(ms) / (sum(ms) / 1e3 * ctx.peak.fp32_flops)
