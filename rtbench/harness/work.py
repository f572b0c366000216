"""Operations and bytes of the port's kernels on a cell's inputs, from
the reference's counts (rtbench/reference/*: `Counts`), and their
roofline shares. Each input is read once and each output written once:

* chain_trace (a launch traces R rays): reads o, d (24 R) and the scene,
  writes the frame (12 R); the tape of the taping kernel is the port's own
  and is not counted;
* chain_grad (R rays): reads o, d and the frame's cotangent (36 R) and the
  scene, writes the scene's gradient; the rays' cotangents are not needed
  when the camera does not train. Its operations are the pullbacks of the
  reference's `Counts.adjoint_ops`; the forward's hit state costs either
  every test again (`trace_ops`) or a least hit record read back
  (`record_bytes`), and the bound takes whichever is cheaper on the card;
* spp_trace (R pixels): reads the pixel coordinates (8 R), the camera and
  the scene, writes the frame (12 R).
"""

from __future__ import annotations

import re

#: The port's CUDA kernels by family (identifiers in the profiler trace).
KERNELS = {
    "chain_trace": ("chain_trace_kernel", "chain_trace_staged_kernel"),
    "chain_grad": ("chain_grad_kernel",),
    "spp_trace": ("spp_trace_kernel", "spp_trace_staged_kernel"),
}
#: Any kernel of the port's csrc/ (the glue is everything else).
PORT_KERNEL = re.compile(r"^(chain_trace|chain_grad|spp_trace|wavefront)\w*_kernel$")


def per_launch(ctx, family: str) -> tuple[float, float] | None:
    """(operations, bytes) of one launch of `family` in the cell, on the
    card `ctx.peak` (None where it has no peak)."""
    c = ctx.counts
    if ctx.peak is None:
        return None
    if ctx.kind == "train":
        step, launches = c["step"], max(1, round(c["step"].rays / c["pixels"]))
        rays = c["pixels"]
        if family == "chain_trace":
            return step.trace_ops() / launches, 36 * rays + c["scene_bytes"]
        if family == "chain_grad":
            io = 36 * rays + 2 * c["scene_bytes"]
            again = ((step.adjoint_ops() + step.trace_ops()) / launches, io)
            record = (step.adjoint_ops() / launches, io + step.record_bytes() / launches)
            return min(again, record, key=lambda w: ctx.peak.bound_s(*w)[0])
        return None
    frame = c["frame"]
    if family == "chain_trace" and frame.rays == c["pixels"]:
        return frame.trace_ops(), 36 * c["pixels"] + c["scene_bytes"]
    if family == "spp_trace" and frame.rays > c["pixels"]:
        return frame.trace_ops(), 20 * c["pixels"] + 16 + c["scene_bytes"]
    return None


def roofline_pct(ctx, family: str) -> float | None:
    """Sum of the launches' bounds over their device time, in %; for a
    render cell over the frames of the compared frame's pose."""
    work = per_launch(ctx, family)
    durs = ctx.trace.launches(KERNELS[family])
    if work is None or not durs:
        return None
    if ctx.kind == "render":
        if len(durs) != len(ctx.traced):
            return None
        durs = [d for d, pose in zip(durs, ctx.traced) if pose == ctx.compared_pose]
        if not durs:
            return None
    bound, _ = ctx.peak.bound_s(*work)
    return 100.0 * bound * len(durs) / sum(durs)


def step_ops(ctx) -> float:
    c = ctx.counts
    if ctx.kind == "train":
        return c["step"].trace_ops() + c["step"].adjoint_ops()
    return c["frame"].trace_ops()
