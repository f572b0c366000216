"""BENCHMARK.json: every entry found by name, malformed ones refused."""

import copy
import json

import pytest

from rtbench.harness import registry


@pytest.fixture(scope="module")
def bench():
    return registry.load()


def test_every_cell_finds_its_files(bench):
    for cell in bench.cells.values():
        cfg = bench.config(cell)
        assert cfg["name"] == cell.config
        assert bench.traffic(cell)["kind"] in ("render", "train")
        assert set(bench.limits(cell))
        for trace in (False, True):
            metrics = bench.metrics_for(cell, trace)
            assert metrics, (cell.name, trace)
            if trace:
                for m in metrics:
                    assert callable(bench.reader(m).read)
        names = {m.name for m in bench.metrics_for(cell, False)}
        assert "setup_s" in names and len(names) >= 2


def test_contract_limits(bench):
    raw = bench.raw
    assert raw["command"] == ["python3", "rtbench/run.py"] and raw["paths"] == ["rtbench"]
    assert 1 <= raw["run_seconds"] <= 51
    assert len(json.dumps(raw)) <= 64 * 1024
    assert sum(c.chips == 4 for c in bench.cells.values()) <= max(1, len(bench.cells) // 4)
    for m in bench.end_to_end:
        assert m.source in registry.SOURCES_E2E
    for m in bench.per_layer:
        if m.name.endswith("_roofline") or "mfu" in m.name:
            assert m.unit == "%"


def _broken(raw, path, value):
    raw = copy.deepcopy(raw)
    node = raw
    for k in path[:-1]:
        node = node[k]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return raw


BROKEN = [
    ("extra top key", ("notes",), "x"),
    ("missing key", ("run_seconds",), KeyError),
    ("name with a space", ("workloads", 0, "name"), "head box"),
    ("unknown config", ("workloads", 0, "config"), "nope"),
    ("chips 2", ("workloads", 0, "chips"), 2),
    ("bound too loose", ("end_to_end", 0, "bound"), 0.3),
    ("bound under 1%", ("end_to_end", 0, "bound"), 0.001),
    ("unit with a space", ("end_to_end", 0, "unit"), "rays per s"),
    ("per-layer source host", ("per_layer", 0, "source"), "magic"),
    ("moves unknown", ("per_layer", 0, "moves"), "nope"),
    ("why with a newline", ("configs", 0, "why"), "a\nb"),
    ("extra metric key", ("per_layer", 0, "why"), "x"),
    ("better sideways", ("per_layer", 0, "better"), "sideways"),
]


@pytest.mark.parametrize("what,path,value", BROKEN, ids=[b[0] for b in BROKEN])
def test_malformed_entry_refused(bench, what, path, value):
    with pytest.raises(registry.BenchError):
        registry.parse(_broken(bench.raw, path, value), bench.root)


def test_unknown_workload_and_missing_reader(bench, tmp_path):
    with pytest.raises(registry.BenchError):
        bench.cell("no.such.cell")
    raw = _broken(bench.raw, ("per_layer", 0, "name"), "no_reader_here")
    b = registry.parse(raw, bench.root)
    with pytest.raises(registry.BenchError):
        b.reader(b.per_layer[0])
