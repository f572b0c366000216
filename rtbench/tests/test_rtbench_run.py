"""The runner: no result without a card, no device metric from a CPU run,
and a run of each cell at a tiny size on the CPU that comes out correct,
while the control (the reference in bfloat16 in the program's place) and
every fault the cell can have come out not correct."""

import io
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from rtbench import control
from rtbench.harness import cell as cell_mod
from rtbench.harness import registry

ROOT = Path(__file__).resolve().parents[2]
#: Tiny sizes that keep the traffic's kind, spp and settings.
TINY = {"train": (24, 16), "render": (32, 20)}


@pytest.fixture(scope="module")
def bench():
    return registry.load()


def tiny(bench, name):
    tr = dict(bench.traffic(bench.cell(name)))
    tr["width"], tr["height"] = TINY[tr["kind"]]
    tr["spp"] = min(tr["spp"], 4)
    return tr


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "head_box.train_1080p", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_only_benchmark_files_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "stress64.render_4k", "--seed", "5",
         "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


CELLS = ["head_box.train_1080p", "stress64.render_4k", "head_box.render_1000_spp32",
         "head_box.train_1080p_spp4"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_correct_and_no_device_metric(bench, name):
    res = cell_mod.execute(bench, bench.cell(name), 2**31 + 11, 0.5, False, time.perf_counter(),
                           device="cpu", traffic=tiny(bench, name), log=io.StringIO())
    assert res["correct"], res["compared"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "compared"
    json.dumps(res)


CASES = [(n, k) for n in CELLS
         for k in ("control",) + control.FAULTS[
             "train" if "train" in n else "render"]]


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_control_and_faults_incorrect(bench, name, kind):
    (rec,) = control.readings(bench, bench.cell(name), [], [2**31 + 29], 0.5, device="cpu",
                              traffic=tiny(bench, name), kinds=(kind,))
    assert not rec["correct"], rec


@pytest.mark.gpu
def test_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "head_box.train_1080p", "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
