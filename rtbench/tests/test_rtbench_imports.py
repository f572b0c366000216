"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the package
under test."""

import ast
from pathlib import Path

import pytest

RTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "raytracingengine_tpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(RTBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(RTBENCH)) for p in FILES])
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


def test_whole_name_compare():
    # the package under test's name begins with the JAX package's: a prefix
    # test would refuse it
    assert "raytracingengine_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((RTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not _imports(path) - {"__future__", "dataclasses", "math", "numpy", "torch"}


def test_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = ("import sys, runpy; sys.argv=['run.py', '--help']\n"
            "try:\n runpy.run_path('rtbench/run.py', run_name='__main__')\n"
            "except SystemExit: pass\n"
            "from rtbench.harness import cell, judge, program, registry, trace, work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'raytracingengine_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=RTBENCH.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
