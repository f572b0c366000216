"""Share of the traced window of training steps in which no device
operation runs (kernels, copies, sets), in %: `harness/trace.py::
Trace.idle_pct`. The profiler's host overhead is in the window, so it
reads above the untraced window's idle share."""


def read(ctx):
    return ctx.trace.idle_pct() if ctx.kind == "train" else None
