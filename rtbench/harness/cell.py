"""One run of one cell: set-up, the measured window, the traced window
(`--trace 1`), the comparison with the reference, and the result line.

The order matters: set-up (building the scene, the kernels' library at
its first use, the cell's warm-up or first training steps) ends when the
window opens; the window's numbers and the device's memory peak are read
before the program's state is freed; the reference runs last, so its own
memory and time touch no metric.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from rtbench.harness import judge, peaks, program, registry, work
from rtbench.harness import trace as trace_mod

#: Top-level module names that may not be loaded in the process that prints
#: the result (compared whole: the package under test's name begins with
#: the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingengine_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads (rtbench/metrics/<name>.py)."""

    cell: str
    kind: str  # "render" or "train"
    trace: trace_mod.Trace
    traced: list[int]  # the camera pose of each traced iteration (0 in training)
    window: program.Window  # the measured window: host-clock latencies and poses
    counts: dict  # the reference's work counts (judge.Verdict.counts)
    compared_pose: int | None  # render: the pose of the compared frame
    peak: peaks.Peak | None


def traced_window(run, start: int, min_seconds: float, min_iterations: int, trace_dir: str):
    """Iterations under torch.profiler until both floors are met -> (the
    trace file, each traced iteration's pose, next index)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(run.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    poses, i = [], start
    with profile(activities=acts) as prof:
        program._sync(run.device)
        with record_function(trace_mod.WINDOW):
            t0 = time.perf_counter()
            while True:
                with record_function(f"rtbench.{run.kind}_iteration"):
                    run.iteration(i)
                poses.append(run.pose_of(i))
                i += 1
                if i - start >= min_iterations and time.perf_counter() - t0 >= min_seconds:
                    break
            program._sync(run.device)
    path = os.path.join(trace_dir, "rtbench.pt.trace.json")
    prof.export_chrome_trace(path)
    return path, poses, i


def execute(bench: registry.Benchmark, cell: registry.Cell, seed: int, seconds: float,
            trace: bool, t_start: float, device="cuda", fault: str | None = None,
            traffic: dict | None = None, control: bool = False, log=sys.stderr) -> dict:
    """Run the cell once -> the result object (without printing it).

    `fault` plants a fault in the program (program.FAULTS) and `control`
    puts the reference in bfloat16 in the program's place for the
    comparison: both for the control's readings and tests. Off the card
    (`device` "cpu", tests only) the result holds no metric."""
    config = bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    limits = bench.limits(cell)
    t_import = time.perf_counter() - t_start
    run = program.make_run(config, traffic, seed, device, fault)
    t_made = time.perf_counter() - t_start
    nxt = program.warm_up(run, int(traffic.get("warmup", 0)))
    run.begin_window()
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    win = program.run_window(run, seconds, nxt)
    trace_info = None
    if trace:
        tmp = tempfile.mkdtemp(prefix="rtbench_trace_")
        try:
            path, traced_poses, _ = traced_window(run, nxt + win.iterations,
                                          float(traffic.get("trace_seconds", 2.0)),
                                          int(traffic.get("poses", 1)) + 2, tmp)
            trace_info = (trace_mod.read(path), traced_poses)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    memory_peak = max(peak_setup, win.peak_bytes)
    out = run.outputs()
    poses = getattr(run, "poses", None)
    phases = run.phases
    run.free()
    del run
    if cuda:
        torch.cuda.empty_cache()
    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"rtbench: modules loaded that must not be: {bad_mods}")
    t_ref = time.perf_counter()
    if traffic["kind"] == "render":
        verdict = judge.judge_render(config, traffic, out, poses, device, limits, control)
    else:
        verdict = judge.judge_train(config, traffic, out, device, limits, control)
    t_ref = time.perf_counter() - t_ref
    rays = win.iterations * traffic["width"] * traffic["height"] * traffic["spp"]
    e2e = {
        "setup_s": setup_s,
        "train_mrays_s": rays / win.seconds / 1e6,
        "render_mrays_s": rays / win.seconds / 1e6,
        "frame_p95_ms": percentile(win.latencies_ms, 95),
        "train_peak_mib": win.peak_bytes / 2**20,
    }
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None  # a CPU run (tests) measures nothing of the device
    if cuda and not trace:
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit}
                   for m in bench.metrics_for(cell, trace=False)}
    elif cuda:
        tr, traced_poses = trace_info
        ctx = Context(cell.name, traffic["kind"], tr, traced_poses, win, verdict.counts,
                      out.get("pose"), peaks.for_device(device_info["kind"]))
        for m in bench.metrics_for(cell, trace=True):
            value = bench.reader(m).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        for family in work.KERNELS:
            per = work.per_launch(ctx, family)
            if per is not None:
                bound, by = ctx.peak.bound_s(*per)
                print(f"rtbench: {family} bound {bound * 1e3:.6f} ms a launch, set by {by} "
                      f"({per[0]:.6g} operations, {per[1]:.6g} bytes)", file=log)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": sorted(tr.by_kernel().items(), key=lambda kv: -kv[1])[:10],
                     "idle_gaps": tr.idle_gaps(10)}
    result = {"correct": verdict.correct and win.failed == 0, "attempted": win.iterations,
              "failed": win.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": verdict.limits[k]}
                          for k, v in verdict.numbers.items()}
    extra = {"setup_s": setup_s, "import_s": t_import, "made_s": t_made, **phases,
             "window_s": win.seconds, "iterations": win.iterations,
             "latency_ms_median": statistics.median(win.latencies_ms), "reference_s": t_ref,
             "total_s": time.perf_counter() - t_start, "seam_px": verdict.counts.get("seam_px"),
             "worst": verdict.counts.get("worst"), "left_out": verdict.counts.get("left_out")}
    print("rtbench: " + json.dumps(extra), file=log)
    for k, v in verdict.numbers.items():
        print(f"compared {k} {v!r} limit {verdict.limits[k]!r}", file=log)
    return result
