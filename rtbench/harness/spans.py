"""The device's idle time of a traced window, charged to the program layer
the host was in.

The port opens `rte.<family>[.<name>]` profiler ranges at its host layers
(`raytracingengine_tpu_torch/utils/profiling.py::span`): `rte.tables`,
`rte.rays`, `rte.launch.<kernel>`, `rte.autograd`, `rte.optimizer`,
`rte.tonemap`. They are host ranges of the same Chrome trace as the device
events (`harness/trace.py`), on one clock. Every instant of the window in
which no device operation runs (the idle time `Trace.idle_pct` counts) is
charged to the innermost `rte.` range open at that instant on any thread
(the one that started last; on a tie the shortest), and to `unspanned`
where none is open: the caller's own code between the port's calls. So
the families and `unspanned` add up to the window's idle time.
"""

from __future__ import annotations

PREFIX = "rte."
UNSPANNED = "unspanned"


def family(name: str) -> str:
    """"rte.launch.chain_grad" -> "launch"; "rte.tables" -> "tables"."""
    return name[len(PREFIX):].split(".", 1)[0]


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The stretches (us) of the window in which no device event runs."""
    out, end = [], trace.window[0]
    for _, ts, dur, _ in sorted(trace.device, key=lambda e: e[1]):
        if ts > end:
            out.append((end, ts))
        end = max(end, ts + dur)
    if trace.window[1] > end:
        out.append((end, trace.window[1]))
    return out


def idle_by_family(trace) -> dict[str, float] | None:
    """Idle seconds of the window by span family, with `unspanned`; None
    where the window holds no `rte.` range (a program without spans)."""
    spans = [(ts, ts + dur, family(name)) for name, ts, dur in trace.host
             if name.startswith(PREFIX)]
    if not spans:
        return None
    # Sweep the window's boundaries in time order: at each, the ranges that
    # open and close there, and the idle stretches that begin and end.
    OPEN, CLOSE, IDLE_ON, IDLE_OFF = 0, 1, 2, 3
    events = []
    for k, (lo, hi, _) in enumerate(spans):
        events.append((lo, OPEN, k))
        events.append((hi, CLOSE, k))
    for lo, hi in idle_intervals(trace):
        events.append((lo, IDLE_ON, -1))
        events.append((hi, IDLE_OFF, -1))
    events.sort(key=lambda e: (e[0], e[1]))
    out = dict.fromkeys(sorted({f for _, _, f in spans}), 0.0)
    out[UNSPANNED] = 0.0
    active: set[int] = set()
    idle, last = 0, events[0][0]
    for t, kind, k in events:
        if idle and t > last:
            if active:
                inner = max(active, key=lambda j: (spans[j][0], spans[j][0] - spans[j][1]))
                out[spans[inner][2]] += t - last
            else:
                out[UNSPANNED] += t - last
        last = t
        if kind == OPEN:
            active.add(k)
        elif kind == CLOSE:
            active.discard(k)
        elif kind == IDLE_ON:
            idle += 1
        else:
            idle -= 1
    return {f: us / 1e6 for f, us in out.items()}


def idle_ms(ctx, fam: str, kind: str) -> float | None:
    """A reader's value: `fam`'s idle ms per traced iteration in a cell of
    `kind`, 0.0 where the family read nothing; None off its kind or where the
    window holds no `rte.` range."""
    if ctx.kind != kind or not ctx.traced:
        return None
    by = idle_by_family(ctx.trace)
    if by is None:
        return None
    return 1e3 * by.get(fam, 0.0) / len(ctx.traced)
