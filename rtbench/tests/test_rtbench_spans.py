"""The span readers (harness/spans.py, metrics/*_idle_ms.*.py) on a hand-made
trace: device events, and nested `rte.` host ranges on two threads (the
main thread and the autograd engine's), whose idle time is worked out by
hand below."""

import pytest

from rtbench.harness import cell, registry, spans
from rtbench.harness.trace import Trace

#: Device busy 10-30 and 50-60 of the window 0-100 us: idle 0-10, 30-50,
#: 60-100 (70 us).
DEVICE = [("chain_trace_staged_kernel", 10.0, 20.0, "kernel"), ("gpu_memcpy", 50.0, 10.0, "gpu_memcpy")]
HOST = [
    ("rtbench.train_iteration", 0.0, 100.0),  # the caller's range: no layer
    ("rte.tables", 0.0, 8.0),
    ("rte.autograd", 32.0, 38.0),  # main thread: the loss and backward()
    ("rte.launch.chain_trace", 35.0, 10.0),
    ("rte.autograd", 40.0, 8.0),  # the engine's thread: a Function's backward
    ("rte.optimizer", 62.0, 18.0),
    ("rte.rays", 85.0, 10.0),  # starts with the shorter tonemap: the tie
    ("rte.tonemap", 85.0, 5.0),
]
#: Idle us by family: tables 0-8; unspanned 8-10, 30-32, 80-85, 95-100;
#: autograd 32-35 (main), 40-48 (the engine's, started last), 48-50 and
#: 60-62 (main); launch 35-40; optimizer 62-80; tonemap 85-90; rays 90-95.
EXPECTED_US = {"tables": 8.0, "unspanned": 14.0, "autograd": 15.0, "launch": 5.0,
               "optimizer": 18.0, "tonemap": 5.0, "rays": 5.0}
ITERATIONS = 2


@pytest.fixture(scope="module")
def bench():
    return registry.load()


def _ctx(kind, host=HOST):
    tr = Trace((0.0, 100.0), list(DEVICE), list(host))
    return cell.Context("test", kind, tr, [0] * ITERATIONS, None, {}, None, None)


def _readers(bench, suffix):
    return {m.name.split("_idle_ms")[0]: bench.reader(m) for m in bench.per_layer
            if m.name.endswith(f"_idle_ms.{suffix}")}


def test_attribution_by_hand():
    by = spans.idle_by_family(_ctx("train").trace)
    assert by == pytest.approx({k: v / 1e6 for k, v in EXPECTED_US.items()})


@pytest.mark.parametrize("kind,families", [
    ("train", {"tables", "rays", "launch", "autograd", "optimizer", "unspanned"}),
    ("render", {"tables", "rays", "launch", "tonemap", "unspanned"}),
])
def test_readers_and_their_sum(bench, kind, families):
    readers = _readers(bench, kind)
    assert set(readers) == families
    ctx = _ctx(kind)
    got = {f: r.read(ctx) for f, r in readers.items()}
    for f, v in got.items():
        assert v == pytest.approx(EXPECTED_US[f] / 1e3 / ITERATIONS), f
    # every idle instant is charged once: the families of a kind and what the
    # other kind's readers alone read add up to the idle ms per iteration
    others = sum(EXPECTED_US[f] for f in set(EXPECTED_US) - families) / 1e3 / ITERATIONS
    idle_ms = ctx.trace.idle_pct() / 100 * ctx.trace.window_s * 1e3 / ITERATIONS
    assert sum(got.values()) + others == pytest.approx(idle_ms)
    # off its kind a reader reads nothing
    other = "render" if kind == "train" else "train"
    assert all(r.read(_ctx(other)) is None for r in readers.values())


def test_zero_family_reads_zero_and_no_span_reads_none(bench):
    readers = {**{f"{f}.train": r for f, r in _readers(bench, "train").items()},
               **{f"{f}.render": r for f, r in _readers(bench, "render").items()}}
    no_rays = [h for h in HOST if h[0] != "rte.rays"]
    assert readers["rays.train"].read(_ctx("train", no_rays)) == pytest.approx(0.0)
    assert readers["rays.train"].read(_ctx("train", no_rays)) is not None
    no_spans = [h for h in HOST if not h[0].startswith("rte.")]
    for name, r in readers.items():
        kind = name.split(".")[-1]
        assert r.read(_ctx(kind, no_spans)) is None, name


def test_idle_gaps_name_the_span():
    # the longest gap, 60-100 us, is named by the innermost range open at its
    # middle: the optimizer's span, not the caller's iteration
    assert _ctx("train").trace.idle_gaps(1)[0][0] == "rte.optimizer"
