"""The plain glass reference's work counts and its culled closest hit, on
the CPU: a hand count on a hand-built ray set, the count against the
linear scan's on the glass_mesh configuration, and the culled hits
against all pairs."""

import ast
import io
import json
import time
from pathlib import Path

import pytest
import torch

from rtbench import control
from rtbench.harness import cell as cell_mod
from rtbench.harness import judge, registry
from rtbench.reference import glass as ref
from rtbench.reference import whitted

CFG = {"bias": 1e-3, "min_weight": 1e-8, "max_depth": 10}


def _two_triangles_and_a_pane():
    """Opaque triangles A (z = 5) and B (z = 10) across the z axis, a
    transparent sphere (tau 0.5) between A and the light on the axis."""
    opaque = {"color": [1.0, 1.0, 1.0]}
    tri = [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]
    desc = {
        "spheres": [{"center": [0.0, 0.0, -3.0], "radius": 1.0,
                     "material": {"color": [1.0, 1.0, 1.0], "transparency": 0.5,
                                  "refractive_index": 1.0}}],
        "meshes": [{"vertices": tri, "indices": [0, 1, 2], "translation": [0.0, 0.0, z],
                    "material": opaque} for z in (5.0, 10.0)],
        "lights": [{"position": [0.0, 0.0, -10.0], "color": [1, 1, 1], "intensity": 100.0}],
    }
    o = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    return desc, o, d


def test_counts_exact_by_hand():
    """Ray 0 hits A at t = 5: its segment meets A's box and the sphere is
    tested, B's box lies past the hit. A's shadow ray marches through the
    sphere: its front (T 0.5), its back (T 0.25), then nothing up to the
    light, 3 steps of one sphere test each, and no triangle's box lies
    ahead of it. Ray 1 misses everything: one sphere test, no box met."""
    desc, o, d = _two_triangles_and_a_pane()
    P = ref.prims(ref.scene_leaves(desc, "cpu"))
    c = ref.Counts()
    img = ref.trace(P, o, d, CFG, c)
    assert (c.rays, c.queries, c.steps) == (2, 2, 3)
    assert c.closest == [2, 0, 1]
    assert c.shadow == [3, 0, 0]
    assert c.trace_ops() == 5 * ref.OPS["sphere"] + ref.OPS["triangle"]
    # A lit through the pane: 100 * 0.25 / |(0,0,-10) - (0,0,5)|^2
    lit = 100.0 * 0.25 / 15.0 ** 2
    assert torch.allclose(img[0], torch.full((3,), lit), rtol=1e-3)
    assert torch.allclose(img[1], whitted.sky(d[1:]).reshape(3))


CELL = "glass_mesh.render_1080p"


@pytest.fixture(scope="module")
def bench():
    return registry.load()


@pytest.fixture(scope="module")
def glass_mesh(bench):
    return registry.load_json(bench.root / bench.configs["glass_mesh"]["file"], "glass_mesh")


def tiny(bench):
    """The cell's traffic at 16x12 with no warm-up: the port's plain
    version of the culled glass kernel takes seconds a frame on the CPU."""
    return dict(bench.traffic(bench.cell(CELL)), width=16, height=12, warmup=0)


def test_count_at_most_linear_on_glass_mesh(glass_mesh):
    cam = dict(glass_mesh["camera"], focal=16.0)
    P = ref.prims(ref.scene_leaves(glass_mesh["scene"], "cpu"))
    c = ref.Counts()
    ref.render(P, cam, 16, 12, 1, 3, judge._settings(glass_mesh), c)
    S, Pn, T = P.counts
    assert (S, Pn, T) == (2, 1, 6016)
    assert c.closest[:2] == [c.queries * S, c.queries * Pn]
    assert c.shadow[:2] == [c.steps * S, c.steps * Pn]
    assert 0 < c.closest[2] + c.shadow[2] < (c.queries + c.steps) * T


def test_culled_closest_equals_all_pairs(glass_mesh):
    P = ref.prims(ref.scene_leaves(glass_mesh["scene"], "cpu"))
    g = torch.Generator().manual_seed(0)
    o = torch.randn(3000, 3, generator=g) * 3.0
    aim = torch.tensor([0.137, 0.5, 8.0]) + torch.randn(3000, 3, generator=g) * 1.5
    d = whitted._normalize(aim - o)
    t, j = ref.closest(P, o, d)
    t_all = whitted._all_t(P.base, o, d)
    j_all = t_all.argmin(1)
    t_lin = t_all.gather(1, j_all[:, None])[:, 0]
    hit = torch.isfinite(t_lin)
    assert int(hit.sum()) > 1000
    assert torch.equal(t, t_lin)
    assert torch.equal(j[hit], j_all[hit])


def test_imports_only_its_sibling():
    """glass.py imports the standard modules, torch and numpy, and of
    the benchmark only its sibling reference whitted.py (relatively)."""
    tree = ast.parse(Path(ref.__file__).read_text())
    absolute, relative = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            (relative if node.level else absolute).add(node.module or node.names[0].name)
    assert absolute <= {"__future__", "dataclasses", "math", "numpy", "torch"}
    assert relative == {"whitted"}


def test_cell_sound_run_correct(bench):
    res = cell_mod.execute(bench, bench.cell(CELL), 2**31 + 11, 0.1, False, time.perf_counter(),
                           device="cpu", traffic=tiny(bench), log=io.StringIO())
    assert res["correct"], res["compared"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    json.dumps(res)


@pytest.mark.parametrize("kind", ("control",) + control.FAULTS["render"])
def test_cell_control_and_fault_incorrect(bench, kind):
    (rec,) = control.readings(bench, bench.cell(CELL), [], [2**31 + 29], 0.1, device="cpu",
                              traffic=tiny(bench), kinds=(kind,))
    assert not rec["correct"], rec
