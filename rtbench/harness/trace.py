"""The profiler's Chrome trace -> device events inside the traced window.

A frozen copy of the trace reading of the package's utils/profiling.py
(the events of categories "kernel", "gpu_memcpy", "gpu_memset", and the
host's "cpu_op" and "user_annotation" ranges), kept here so that a change
to the package cannot move the yardstick. The window is the
`rtbench.traced_window` range the harness opens around the traced
iterations; device time is the union of the device events inside it.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "rtbench.traced_window"


def kernel_id(name: str) -> str:
    """A demangled kernel name -> its bare identifier:
    "void (anonymous namespace)::chain_trace_staged_kernel<2, true>(rte::Tables, ...)"
    -> "chain_trace_staged_kernel"."""
    s = name
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):  # drop the argument list: the last top-level "(...)"
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and s[i - 1] not in " :":
            cut = i
    s = s[:cut]
    while "<" in s:  # template arguments, innermost first
        s = re.sub(r"<[^<>]*>", "", s)
    s = s.split("::")[-1].strip()
    return s.split(" ")[-1] if s else name


@dataclasses.dataclass
class Trace:
    """Device events [(identifier, start us, duration us, category)] and
    host ranges [(name, start us, duration us)] clipped to the window."""

    window: tuple[float, float]
    device: list[tuple[str, float, float, str]]
    host: list[tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (union of intervals)."""
        total, end = 0.0, -1e300
        for _, ts, dur, _ in sorted(self.device, key=lambda e: e[1]):
            lo, hi = max(ts, end), ts + dur
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
        return total / 1e6

    def idle_pct(self) -> float | None:
        """Share of the window in which no device operation runs, in %."""
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def by_kernel(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for ident, _, dur, _ in self.device:
            out[ident] = out.get(ident, 0.0) + dur / 1e6
        return out

    def launches(self, idents) -> list[float]:
        """Durations (s) of the kernels whose identifier is in `idents`, in
        order of start."""
        return [dur / 1e6 for ident, ts, dur, cat in sorted(self.device, key=lambda e: e[1])
                if cat == "kernel" and ident in idents]

    def idle_gaps(self, n: int = 10) -> list[tuple[str, float]]:
        """The longest stretches of the window with no device operation,
        each named by the innermost host range (an operator, or a range
        of the benchmark's) open at its middle."""
        gaps, end = [], self.window[0]
        for _, ts, dur, _ in sorted(self.device, key=lambda e: e[1]):
            if ts > end:
                gaps.append((end, ts))
            end = max(end, ts + dur)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for lo, hi in gaps[:n]:
            mid = 0.5 * (lo + hi)
            open_ = [(name, dur) for name, ts, dur in self.host
                     if ts <= mid <= ts + dur and name != WINDOW]
            pick = min(open_, key=lambda x: x[1], default=("(host idle)", 0.0))
            out.append((pick[0], (hi - lo) / 1e6))
        return out


def read(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not spans:
        raise ValueError(f"trace {path}: no {WINDOW} range")
    w = spans[-1]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0.0))
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if ts + dur < lo or ts > hi:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(ts, lo), min(ts + dur, hi)
            device.append((kernel_id(e["name"]) if cat == "kernel" else cat, a, b - a, cat))
        elif cat in HOST_CATS:
            host.append((e["name"], ts, dur))
    return Trace((lo, hi), device, host)
