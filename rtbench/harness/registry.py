"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in a file of
its own, and so does each per-layer metric's reader and each cell's
limits:

    rtbench/configs/<config>.json      the scene, camera and program settings
    rtbench/traffic/<traffic>.json     what a run does with them
    rtbench/metrics/<metric>.py        def read(ctx) -> float | None
    rtbench/limits/<cell>.json         each compared number's limit

so a later change adds a cell, a configuration or a metric by adding files
and entries. Every entry is checked here, and a malformed one refused,
before anything runs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # rtbench/
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


class BenchError(ValueError):
    """A malformed or missing benchmark entry."""


def _line(s, what: str, limit: int = 200) -> str:
    if not isinstance(s, str) or not 1 <= len(s) <= limit or "\n" in s or "\t" in s:
        raise BenchError(f"{what}: expected one line of 1-{limit} characters, got {s!r}")
    return s


def _name(s, what: str) -> str:
    if not isinstance(s, str) or not NAME.match(s):
        raise BenchError(f"{what}: {s!r} is not a name (letters, digits, _ . -; at most 64)")
    return s


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple[str, ...] | None
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Benchmark:
    root: Path
    raw: dict
    configs: dict[str, dict]
    cells: dict[str, Cell]
    end_to_end: list[Metric]
    per_layer: list[Metric]

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, cell: Cell) -> dict:
        return load_json(self.root / self.configs[cell.config]["file"], f"config {cell.config}")

    def traffic(self, cell: Cell) -> dict:
        return load_json(self.root / "rtbench" / "traffic" / f"{cell.traffic}.json",
                         f"traffic {cell.traffic}")

    def limits(self, cell: Cell) -> dict[str, float]:
        lim = load_json(self.root / "rtbench" / "limits" / f"{cell.name}.json",
                        f"limits of {cell.name}")
        for k, v in lim.items():
            _name(k, "limit name")
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise BenchError(f"limit {k} of {cell.name}: not a number")
        return lim

    def metrics_for(self, cell: Cell, trace: bool) -> list[Metric]:
        return [m for m in (self.per_layer if trace else self.end_to_end) if m.applies(cell.name)]

    def reader(self, metric: Metric):
        """The reader module of a per-layer metric (rtbench/metrics/<name>.py)."""
        path = self.root / "rtbench" / "metrics" / f"{metric.name}.py"
        if not path.is_file():
            raise BenchError(f"per-layer metric {metric.name}: no reader at {path}")
        spec = importlib.util.spec_from_file_location(f"rtbench_metric_{metric.name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if not callable(getattr(mod, "read", None)):
            raise BenchError(f"per-layer metric {metric.name}: its reader has no read(ctx)")
        return mod


def load_json(path: Path, what: str):
    if not path.is_file():
        raise BenchError(f"{what}: no file {path}")
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise BenchError(f"{what}: {path} is not JSON ({e})") from e


def _keys(entry, kind: str, extra=()) -> None:
    if not isinstance(entry, dict):
        raise BenchError(f"{kind}: entry {entry!r} is not an object")
    want = KEYS[kind]
    got = set(entry)
    if not want <= got or got - want - set(extra):
        raise BenchError(f"{kind} entry {entry.get('name')!r}: keys {sorted(got)}, "
                         f"expected {sorted(want)}" + (f" (+ {list(extra)})" if extra else ""))


def _metric(e: dict, kind: str, cells: dict) -> Metric:
    _keys(e, kind, extra=("workloads",))
    name = _name(e["name"], f"{kind} name")
    if not isinstance(e["unit"], str) or not UNIT.match(e["unit"]):
        raise BenchError(f"metric {name}: bad unit {e['unit']!r}")
    if e["better"] not in ("lower", "higher"):
        raise BenchError(f"metric {name}: better must be lower or higher")
    if e["source"] not in (SOURCES_E2E if kind == "end_to_end" else SOURCES):
        raise BenchError(f"metric {name}: source {e['source']!r} not allowed for {kind}")
    wl = e.get("workloads")
    if wl is not None:
        if not isinstance(wl, list) or not wl or any(w not in cells for w in wl):
            raise BenchError(f"metric {name}: workloads {wl!r} name unknown cells")
        wl = tuple(wl)
    if kind == "end_to_end":
        b = e["bound"]
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            raise BenchError(f"metric {name}: bound {b!r} outside [0.01, 0.25]")
        return Metric(name, e["unit"], e["better"], e["source"], wl, bound=float(b))
    return Metric(name, e["unit"], e["better"], e["source"], wl,
                  layer=_line(e["layer"], f"layer of {name}"), moves=e["moves"])


def parse(raw: dict, root: Path) -> Benchmark:
    if not isinstance(raw, dict) or set(raw) != set(TOP_KEYS):
        raise BenchError(f"BENCHMARK.json: keys {sorted(raw) if isinstance(raw, dict) else raw!r}, "
                         f"expected {sorted(TOP_KEYS)}")
    configs = {}
    for c in raw["configs"]:
        _keys(c, "configs")
        name = _name(c["name"], "config name")
        _line(c["source"], f"source of {name}")
        _line(c["why"], f"why of {name}")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise BenchError(f"config {name}: reduced must be a list of at most 16 keys")
        for k in c["reduced"]:
            _name(k, f"reduced key of {name}")
        if name in configs:
            raise BenchError(f"config {name} appears twice")
        configs[name] = c
    cells = {}
    for w in raw["workloads"]:
        _keys(w, "workloads")
        name = _name(w["name"], "workload name")
        _name(w["traffic"], f"traffic of {name}")
        _line(w["why"], f"why of {name}")
        if w["config"] not in configs:
            raise BenchError(f"workload {name}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise BenchError(f"workload {name}: chips must be 1 or 4")
        if name in cells or any((w["config"], w["traffic"]) == (c.config, c.traffic)
                                for c in cells.values()):
            raise BenchError(f"workload {name}: name or (config, traffic) appears twice")
        cells[name] = Cell(name, w["config"], w["traffic"], w["chips"])
    e2e = [_metric(m, "end_to_end", cells) for m in raw["end_to_end"]]
    per = [_metric(m, "per_layer", cells) for m in raw["per_layer"]]
    names = [m.name for m in e2e + per]
    if len(set(names)) != len(names):
        raise BenchError("two metrics share a name")
    if "setup_s" not in names[:len(e2e)]:
        raise BenchError("end_to_end must hold setup_s")
    e2e_names = {m.name: m for m in e2e}
    for m in per:
        if m.moves not in e2e_names:
            raise BenchError(f"per-layer metric {m.name}: moves unknown metric {m.moves!r}")
        target = e2e_names[m.moves]
        for c in (m.workloads or tuple(cells)):
            if not target.applies(c):
                raise BenchError(f"per-layer metric {m.name}: cell {c} does not report {m.moves}")
    return Benchmark(root, raw, configs, cells, e2e, per)


def load(root: Path = ROOT) -> Benchmark:
    return parse(load_json(root / "BENCHMARK.json", "BENCHMARK.json"), root)
