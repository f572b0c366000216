"""Device profiling as a library call, on torch.profiler.

The reference's observability is one chrono timer around RenderImage
(RaytracingEngine.cpp:292-299). Here any step function runs under
torch.profiler, its Chrome trace is written to a directory, and the trace
is read back into device time by CUDA kernel and by top-level range (the
JAX package's utils/profiling.py, with the same names):

    from raytracingengine_tpu_torch.utils.profiling import profile_step
    report = profile_step(lambda: train_step(params, static, None))
    print(report.pretty())   # device ms by kernel, device total, wall

On a host without a CUDA card the trace has no device events and the
report holds the wall time only, as the JAX package's does on its CPU.

The port opens a span at each host layer it crosses, `span(name)`: a
`torch.profiler.record_function` range while a profiler records (it lands
in the profiler's own Chrome trace as a "user_annotation" event, on the
clock of the device events), and one shared no-op context otherwise, after
a single read of the profiler's Python flag, which every thread sees (the
backward's spans open on the autograd engine's worker thread). The spans,
one family per dotted prefix:

    rte.tables          scene -> flat scene -> the kernels' tables (combine,
                        flatten_scene, pack_scene_tables, the culled packing)
    rte.rays            pixel ids, camera rays, the AA jitter
    rte.launch.<kernel> a kernel wrapper's whole call (kernels/): checks,
                        buffers and the launch, or its plain version on the CPU
    rte.autograd        the autograd Functions' bodies, the per-sample
                        accumulation and join, a step's loss and backward()
    rte.optimizer       a step's zero_grad and optimizer.step
    rte.tonemap         tonemap/operators.py's tonemap and to_uint8

The port opens no span around a whole frame or step: the caller's range is
the root. So under `profile_step` the layer spans are top-level ranges:
`host_ms` gives each layer's host ms and `module_ms` charges each kernel
to the layer that launched it. Two kinds of range sit beside them at the
top: an autograd Function's own range around its forward
(`ChainTraceFused`, holding `rte.autograd` and the launch), and on the
card, where the backward runs on the autograd engine's worker thread, the
engine's `autograd::engine::evaluate_function: <node>` range around each
node (`ChainTraceFusedBackward` holds the adjoint's launch; the other
nodes are the tables' and rays' backward).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import glob
import gzip
import json
import os
import tempfile
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

#: What `span` returns while no profiler records, one object for every span.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range `name` while a profiler
    records, else a shared no-op (one read of a Python flag, no allocation,
    no call into C++)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


#: Chrome-trace categories of the host ranges a kernel is charged to: the
#: operators and the torch.profiler.record_function ranges.
_HOST_RANGES = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class TraceReport:
    """One traced call.

    * `op_ms`: device ms by CUDA kernel name (the trace's "kernel" events,
      summed over launches);
    * `module_ms`: device ms by top-level host range: each kernel's time is
      charged to the outermost operator or record_function range that was
      open on the host thread when it was launched (matched through the
      launch's correlation id), so a range's time includes the kernels of
      every operator inside it;
    * `host_ms`: host ms by top-level operator or record_function range;
    * `device_total_ms`: the sum of `op_ms`, the kernels' busy time (not
      the span from the first kernel to the last);
    * `wall_ms`: the host clock around the call and a synchronise."""

    wall_ms: float
    device_total_ms: float
    op_ms: dict[str, float]
    module_ms: dict[str, float]
    host_ms: dict[str, float]
    trace_dir: str

    def top_ops(self, n: int = 10) -> list[tuple[str, float]]:
        return sorted(self.op_ms.items(), key=lambda kv: -kv[1])[:n]

    def pretty(self, n: int = 10) -> str:
        lines = [
            f"wall {self.wall_ms:.1f} ms | device {self.device_total_ms:.1f} ms "
            f"| host not covered by kernels {self.wall_ms - self.device_total_ms:.1f} ms"
        ]
        for name, ms in self.top_ops(n):
            lines.append(f"  {ms:9.3f} ms  {name[:100]}")
        return "\n".join(lines)


def _newest_trace(trace_dir: str) -> str | None:
    cands = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    return max(cands, key=os.path.getmtime) if cands else None


def _read_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _top_level(ranges: list[dict]) -> tuple[list[float], list[dict]]:
    """Host ranges of one thread -> (start times, ranges) of the outermost
    ones, sorted by start."""
    top, end = [], -1.0
    for e in sorted(ranges, key=lambda e: (e["ts"], -e.get("dur", 0.0))):
        if e["ts"] >= end:
            top.append(e)
            end = e["ts"] + e.get("dur", 0.0)
    return [e["ts"] for e in top], top


def _parse(events: list[dict]) -> tuple[dict, dict, dict]:
    op_ms: dict = collections.defaultdict(float)
    module_ms: dict = collections.defaultdict(float)
    host_ms: dict = collections.defaultdict(float)
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _HOST_RANGES:
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    tops = {k: _top_level(v) for k, v in by_thread.items()}
    for starts, top in tops.values():
        for e in top:
            host_ms[e["name"]] += e.get("dur", 0.0) / 1e3
    # correlation id -> the top-level range around the kernel's launch
    owner = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        corr = e.get("args", {}).get("correlation")
        starts, top = tops.get((e.get("pid"), e.get("tid")), ([], []))
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if corr is not None and i >= 0 and e["ts"] <= top[i]["ts"] + top[i].get("dur", 0.0):
            owner[corr] = top[i]["name"]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        dur_ms = e.get("dur", 0.0) / 1e3  # the trace stores microseconds
        op_ms[e["name"]] += dur_ms
        module_ms[owner.get(e.get("args", {}).get("correlation"), "(no host range)")] += dur_ms
    return dict(op_ms), dict(module_ms), dict(host_ms)


def parse_trace_dir(trace_dir: str) -> tuple[dict, dict]:
    """-> (op_ms, module_ms) of the newest Chrome trace
    (`*.pt.trace.json` or `*.pt.trace.json.gz`) under `trace_dir`, as
    TraceReport defines them; ({}, {}) if there is none."""
    path = _newest_trace(trace_dir)
    if path is None:
        return {}, {}
    op_ms, module_ms, _ = _parse(_read_events(path))
    return op_ms, module_ms


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_step(fn, trace_dir: str | None = None, warmup: int = 1) -> TraceReport:
    """Run `fn()` `warmup` times, then once under torch.profiler (the host
    and, where there is a card, CUDA) -> TraceReport. Each warm-up call and
    the traced call end in a synchronise. The Chrome trace goes to
    `trace_dir` (a new temporary directory by default)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(max(warmup, 0)):
        fn()
        _sync()
    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="rte_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, f"rte_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    op_ms, module_ms, host_ms = _parse(_read_events(path))
    return TraceReport(
        wall_ms=wall_ms,
        device_total_ms=sum(op_ms.values()),
        op_ms=op_ms,
        module_ms=module_ms,
        host_ms=host_ms,
        trace_dir=trace_dir,
    )
