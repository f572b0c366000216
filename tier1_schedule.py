#!/usr/bin/env python3
"""Replay pytest-xdist's `--dist load` scheduling of a test run, to see how a
collection's size moves the slowest worker of the Tier-1 command
(ROADMAP.md: `-n 6 --dist load`).

Given the collection in its order (`pytest --collect-only -q` output) and
each test's duration (the junit XML of a run), it replays xdist's
LoadScheduling (xdist/scheduler/load.py, 3.x): each worker first gets a
chunk of len(collection) // workers // 4 consecutive tests; a worker that
completes a test with fewer than max(2, pending // workers // 4) tests
left in its queue is refilled to max(2, pending // workers // 2), unless
the test took >= 0.1 s and it still holds 2; and a worker runs a test only
once it holds the next one or has been told to shut down. It prints each
worker's summed time and its heaviest tests. Tests missing from the XML
count 0 s.

    python3 tier1_schedule.py --collection collect.txt --junit /tmp/_t1.xml -n 6
"""

from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET


def junit_durations(path: str) -> dict[str, float]:
    """Test node id -> seconds, from a junit XML (setup, call and teardown)."""
    out = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        cls, name = case.get("classname", ""), case.get("name", "")
        parts = cls.split(".")
        # tests.test_x -> tests/test_x.py; tests.test_x.TestK -> tests/test_x.py::TestK
        for k in range(len(parts), 0, -1):
            path_ = "/".join(parts[:k]) + ".py"
            if parts[k - 1].startswith("test"):
                out["::".join([path_, *parts[k:], name])] = float(case.get("time", 0.0))
                break
    return out


def replay(durations: list[float], workers: int) -> list[tuple[float, list[int]]]:
    """-> per worker (summed seconds, the indices of the tests it ran)."""
    pending = list(range(len(durations)))
    queues: list[list[int]] = [[] for _ in range(workers)]
    ran: list[list[int]] = [[] for _ in range(workers)]
    clock = [0.0] * workers
    shutdown = [False] * workers

    def send(w: int, num: int) -> None:
        queues[w].extend(pending[:num])
        del pending[:num]

    chunk = max(min(len(durations) // workers // 4, len(durations)), 2)
    for w in range(workers):
        send(w, chunk)
    if not pending:
        shutdown = [True] * workers
    while True:
        # the worker that completes a test first
        ready = [w for w in range(workers) if queues[w] and (len(queues[w]) >= 2 or shutdown[w])]
        if not ready:
            break
        w = min(ready, key=lambda k: clock[k] + durations[queues[k][0]])
        item = queues[w].pop(0)
        clock[w] += durations[item]
        ran[w].append(item)
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            if len(queues[w]) < lo and not (durations[item] >= 0.1 and len(queues[w]) >= 2):
                send(w, hi - len(queues[w]))
        else:
            shutdown[w] = True
    return list(zip(clock, ran))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--collection", required=True, help="`pytest --collect-only -q` output")
    ap.add_argument("--junit", required=True, help="junit XML of a run, for the durations")
    ap.add_argument("-n", type=int, default=6, help="workers")
    args = ap.parse_args()
    ids = [line.strip() for line in open(args.collection) if "::" in line]
    known = junit_durations(args.junit)
    durations = [known.get(i, 0.0) for i in ids]
    missing = sum(i not in known for i in ids)
    print(f"{len(ids)} tests collected, {missing} without a duration, {sum(durations):.1f} s in all")
    for w, (secs, items) in enumerate(replay(durations, args.n)):
        top = sorted(items, key=lambda i: -durations[i])[:3]
        port = sum(durations[i] for i in items if "test_torch_" in ids[i])
        print(f"  worker {w}: {secs:.1f} s, {len(items)} tests ({port:.1f} s of port tests); heaviest "
              + ", ".join(f"{ids[i]} {durations[i]:.1f} s" for i in top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
