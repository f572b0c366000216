"""The culled wavefront_trace's share of its roofline bound in a render
cell's frames of the compared pose, in %: the bound, max(operations / peak
FLOP/s, bytes / peak bytes/s), of the reference's counts of the compared
frame (rtbench/reference/glass.py: each traced segment's sphere and plane
tests and the tests of the triangles whose own boxes it meets; 36 bytes a
camera ray and the scene once), times those frames' launches of
`wavefront_trace_culled_kernel`, over their device time. None where the
traced window holds no such launch, or not one a frame."""

KERNEL = ("wavefront_trace_culled_kernel",)


def read(ctx):
    if ctx.kind != "render" or ctx.peak is None:
        return None
    durs = ctx.trace.launches(KERNEL)
    if not durs or len(durs) != len(ctx.traced):
        return None
    durs = [d for d, pose in zip(durs, ctx.traced) if pose == ctx.compared_pose]
    if not durs:
        return None
    c = ctx.counts
    bound, _ = ctx.peak.bound_s(c["frame"].trace_ops(), 36 * c["pixels"] + c["scene_bytes"])
    return 100.0 * bound * len(durs) / sum(durs)
