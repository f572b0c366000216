"""The whole training step's share of the card's fp32 peak, in %: the
step's counted operations (the forward's tests and the adjoint's
pullbacks, `harness/work.py`) times the measured window's steps, over the
window's length on the host clock times the peak."""

from rtbench.harness import work


def read(ctx):
    if ctx.peak is None or ctx.kind != "train" or ctx.window.seconds <= 0:
        return None
    ops = work.step_ops(ctx) * ctx.window.iterations
    return 100.0 * ops / (ctx.window.seconds * ctx.peak.fp32_flops)
