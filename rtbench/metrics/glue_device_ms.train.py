"""Device ms per training step in kernels that are not the port's CUDA
kernels: the scene's tables, the camera rays, the autograd glue, the loss
and the optimizer (aten's kernels), over the traced window."""

from rtbench.harness import work


def read(ctx):
    if not ctx.traced or not ctx.trace.device:
        return None
    glue = sum(s for ident, s in ctx.trace.by_kernel().items()
               if ident not in ("gpu_memcpy", "gpu_memset") and not work.PORT_KERNEL.match(ident))
    return 1e3 * glue / len(ctx.traced)
