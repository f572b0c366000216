"""PyTorch port, the user entry points against the JAX package on the CPU:
render/aov.py, scenes/config.py, imageio/obj.py and the CLI.

(d) render_aovs on the head box (camera nudged off the cube's edges, as in
tests/test_torch_grad.py) and the glass sphere against the JAX
render_aovs: each map under the seam budget at atol 1e-5 (a pixel whose
centre ray ties two primitives may take the other). (e) scene_from_dict and
load_scene_json, with a model from refbuild/box.obj, against the JAX
package's, leaf by leaf through convert.scene_to_numpy (equal within fp32
rounding of the same float64 inputs: rtol 1e-6), and load_obj on every
backend against the JAX load_obj(backend="python") exactly, on
refbuild/box.obj, every face form, a 50,000-triangle grid and
cube_obj_text's cube; a broken native build raises for 'native' and falls
back with a warning for 'auto'. (f) The CLI's render, aov and fit
commands with --device cpu write the files the JAX CLI writes; the render
equals render_hdr's tonemapped frame byte for byte; the fit loss falls;
--mesh raises; `python -m raytracingengine_tpu_torch.cli` runs; the
metrics logger writes JSON lines and the NaN/Inf guards raise on a
non-finite leaf.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.imageio.obj import load_obj as jax_load_obj
from raytracingengine_tpu.scenes.assets import cube_mesh as jax_cube_mesh
from raytracingengine_tpu.scenes.assets import cube_obj_text as jax_cube_obj_text
from raytracingengine_tpu.render.aov import render_aovs as jax_render_aovs
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu.scenes.config import load_scene_json as jax_load_scene_json
from raytracingengine_tpu.scenes.config import scene_from_dict as jax_scene_from_dict
from raytracingengine_tpu.tonemap import OPERATORS as JAX_OPERATORS
from raytracingengine_tpu_torch import native_bridge
from raytracingengine_tpu_torch.cli import main
from raytracingengine_tpu_torch.convert import scene_to_numpy
from raytracingengine_tpu_torch.imageio import load_obj, read_png, read_ppm
from raytracingengine_tpu_torch.inverse.checkpoint import restore_checkpoint
from raytracingengine_tpu_torch.parallel import fault
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.aov import render_aovs
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders, cube_obj_text
from raytracingengine_tpu_torch.scenes.config import load_scene_json, scene_from_dict
from raytracingengine_tpu_torch.tonemap import aces_approx, to_uint8
from raytracingengine_tpu_torch.utils.checks import assert_finite, checked
from raytracingengine_tpu_torch.utils.metrics import MetricsLogger, fit_callback

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_OBJ = os.path.join(REPO, "refbuild", "box.obj")


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def test_render_aovs_match_jax():
    """(d) Head box and glass sphere at 12x10."""
    for fn, nudge in (("head_box_scene", (0.013, 0.007, 0.0)), ("glass_sphere_scene", None)):
        j_scene, j_cam = getattr(jax_builders, fn)(width=12, height=10)
        scene, cam = getattr(builders, fn)(width=12, height=10, device="cpu")
        if nudge is not None:
            j_cam = dataclasses.replace(j_cam, position=j_cam.position + jnp.asarray(nudge))
            cam = dataclasses.replace(cam, position=cam.position + torch.tensor(nudge))
        ref = jax_render_aovs(j_scene, j_cam)
        ours = render_aovs(scene, cam)
        assert sorted(ours) == sorted(ref)
        assert 0 < float(ours["hit"].mean()) <= 1.0
        for name, a in ours.items():
            b = np.asarray(ref[name])
            assert tuple(a.shape) == b.shape, name
            if a.dim() == 2:  # depth, hit: one channel
                a, b = a[..., None].expand(*a.shape, 3), np.repeat(b[..., None], 3, axis=-1)
            report = seam_budget(a.numpy(), b, atol=1e-5)
            assert report.ok and np.isfinite(a.numpy()).all(), (fn, name, report)


def obj_cases(tmp_path):
    """refbuild/box.obj, and a file with every face form: v, v/vt, v//vn,
    v/vt/vn, negative indices, a quad (fan), usemtl and an mtllib."""
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\nNs 32\nnewmtl blue\nKd 0 0 1\nd 0.5\n")
    (tmp_path / "forms.obj").write_text(
        "mtllib m.mtl\n# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n"
        "usemtl red\nf 1 2 3\nf 1/1 3/1 4/1\nusemtl blue\nf 1//1 2//1 3//1 4//1\n"
        "f -4/1/1 -3/1/1 -2/1/1\nusemtl red\nf 2 3 4\n")
    return [BOX_OBJ, str(tmp_path / "forms.obj")]


def grid_obj(path, n_quads: int = 25_000) -> str:
    """A seeded height field of `n_quads` quads written as OBJ quads (two
    triangles each by the fan), half of them through negative indices, in two
    usemtl groups; -> its path."""
    rng = np.random.default_rng(11)
    nx = 250
    ny = n_quads // nx
    xs, zs = np.meshgrid(np.arange(nx + 1) * 0.05, np.arange(ny + 1) * 0.05)
    verts = np.stack([xs, rng.normal(0, 0.1, xs.shape), zs], -1).reshape(-1, 3)
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in verts.tolist()]
    for j in range(ny):
        lines.append(f"usemtl {'ab'[j % 2]}")
        for i in range(nx):
            a = j * (nx + 1) + i + 1
            q = (a, a + 1, a + nx + 2, a + nx + 1)
            if j % 2:
                q = tuple(v - len(verts) - 1 for v in q)
            lines.append("f " + " ".join(f"{v}//{v}" if i % 3 == 0 else str(v) for v in q))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_scene_json_and_obj_match_jax(tmp_path, monkeypatch):
    """(e) A scene of every family, a model from refbuild/box.obj, overrides
    and padding; then load_obj on every backend (native, python, auto) and
    the native parser's build errors."""
    desc = {
        "camera": {"position": [0, 0.5, -12], "focal": 40, "width": 20, "height": 16, "near": 0.5,
                   "far": 80, "spp": 2},
        "spheres": [{"center": [0, 0, 5], "radius": 1.5,
                     "material": {"color": [1, 0, 0], "specular": 0.2, "shininess": 32}},
                    {"center": [2, -1, 7], "radius": 0.75,
                     "material": {"color": [0.9, 0.9, 0.9], "transparency": 0.8, "refractive_index": 1.4}}],
        "planes": [{"point": [0, -2, 0], "normal": [0, 2, 0.1], "material": {"color": [1, 1, 1]}}],
        "triangles": [{"v0": [-3, 0, 6], "v1": [-2, 0, 6], "v2": [-3, 1, 6], "translation": [0, 0.5, 0],
                       "material": {"color": [0, 1, 0]}}],
        "models": [{"obj": BOX_OBJ, "translation": [-1, 1, 10],
                    "material": {"color": [0, 0, 1], "specular": 0.5}}],
        "lights": [{"position": [0, 5, 0], "intensity": 40},
                   {"position": [-3, 4, -2], "color": [1, 0.8, 0.6], "intensity": 25}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(desc))
    cases = [
        (jax_scene_from_dict(desc), scene_from_dict(desc, device="cpu")),
        (jax_scene_from_dict(desc, pad_multiple=4), scene_from_dict(desc, pad_multiple=4, device="cpu")),
        (jax_load_scene_json(str(path), width=9, spp=3), load_scene_json(str(path), device="cpu", width=9, spp=3)),
    ]
    for (j_scene, j_cam), (scene, cam) in cases:
        ref, ours = jax_leaves(j_scene), scene_to_numpy(scene)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].shape == ref[k].shape, k
            np.testing.assert_allclose(ours[k].astype(np.float64), ref[k].astype(np.float64), rtol=1e-6,
                                       atol=0, err_msg=k)
        assert scene.has_transparency == j_scene.has_transparency
        assert (cam.width, cam.height, cam.spp) == (j_cam.width, j_cam.height, j_cam.spp)
        for k in ("position", "focal", "near", "far"):
            np.testing.assert_array_equal(getattr(cam, k).numpy(), np.asarray(getattr(j_cam, k)), err_msg=k)
    assert int(cases[0][1][0].triangles.active.sum()) == 13 and cases[2][1][1].width == 9

    (tmp_path / "cube.obj").write_text(cube_obj_text())
    cases = obj_cases(tmp_path) + [grid_obj(tmp_path / "grid.obj"), str(tmp_path / "cube.obj")]
    for obj in cases:
        ref = jax_load_obj(obj, backend="python")
        for backend in ("native", "python", "auto"):
            ours = load_obj(obj, backend=backend)
            assert sorted(ours) == sorted(ref), backend
            for k in ("vertices", "indices", "face_materials"):
                assert ours[k].dtype == ref[k].dtype, (k, backend)
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"{k} {backend}")
            assert ours["materials"] == ref["materials"], backend
            assert ours["material_names"] == ref["material_names"], backend
        if obj.endswith("forms.obj"):
            assert ours["material_names"] == ["red", "blue"] and len(ours["indices"]) == 3 * 6
            assert ours["materials"][0] == {"Kd": (0.8, 0.1, 0.1), "Ns": 32.0}
        if obj.endswith("grid.obj"):
            assert len(ours["indices"]) == 3 * 50_000 and ours["material_names"] == ["a", "b"]
    assert cube_obj_text() == jax_cube_obj_text()
    cube_v, cube_i = jax_cube_mesh()
    np.testing.assert_array_equal(ours["vertices"], cube_v)
    np.testing.assert_array_equal(ours["indices"], cube_i)
    with pytest.raises(ValueError, match="backend"):
        load_obj(BOX_OBJ, backend="bogus")
    # a source that does not compile: 'native' raises with the compiler's
    # output, 'auto' warns once and parses in Python
    (tmp_path / "src").mkdir()
    for name in native_bridge.SOURCES:
        (tmp_path / "src" / name).write_text(f"#error broken {name}\n")
    for name, value in (("NATIVE_SRC", tmp_path / "src"), ("BUILD_DIR", tmp_path / "build"), ("_LIB", None),
                        ("_ERROR", None), ("_WARNED", False)):
        monkeypatch.setattr(native_bridge, name, value)
    with pytest.raises(RuntimeError, match="broken objparser.cpp"):
        load_obj(BOX_OBJ, backend="native")
    with pytest.warns(RuntimeWarning, match="broken objparser.cpp"):
        ours = load_obj(BOX_OBJ)
    np.testing.assert_array_equal(ours["indices"], jax_load_obj(BOX_OBJ, backend="python")["indices"])
    assert not native_bridge.available() and not list((tmp_path / "build").iterdir())


def test_cli_commands(tmp_path, capsys):
    """(f) render (--tonemap all, --format ppm; a JSON scene with a model;
    --mesh on one rank), the fault-tolerant bands with an injected fault,
    aov, fit --steps 3 with a checkpoint, and python -m."""
    out = tmp_path / "render"
    args = ["--width", "16", "--height", "12", "--spp", "2", "--device", "cpu"]
    assert main(["render", "--scene", "baseline_spheres", *args, "--out", str(out), "--tonemap", "all",
                 "--format", "ppm", "--chunk-size", "100"]) == 0
    assert sorted(os.listdir(out)) == sorted(f"{k}.ppm" for k in JAX_OPERATORS)
    scene, cam = builders.baseline_sphere_scene(16, 12, spp=2, device="cpu")
    with torch.no_grad():
        hdr = render_hdr(scene, cam, RenderConfig(chunk_size=100))
    np.testing.assert_array_equal(read_ppm(str(out / "aces.ppm")), to_uint8(aces_approx(hdr)).numpy())
    assert read_ppm(str(out / "aces.ppm")).std() > 5

    desc = {"camera": {"position": [0, 0, -14], "focal": 16, "near": 0, "far": 50},
            "models": [{"obj": os.path.relpath(BOX_OBJ, tmp_path), "translation": [0, 0, 2],
                        "material": {"color": [0, 0, 1], "specular": 0.5}}],
            "planes": [{"point": [0, -3, 0], "normal": [0, 1, 0], "material": {"color": [1, 1, 1]}}],
            "lights": [{"position": [0, 3, -4], "intensity": 20}]}
    (tmp_path / "scene.json").write_text(json.dumps(desc))
    assert main(["render", "--scene", str(tmp_path / "scene.json"), *args, "--out", str(tmp_path / "json"),
                 "--use-pallas", "--shadow-mode", "binary"]) == 0
    box = read_png(str(tmp_path / "json" / "aces.png"))
    assert box.shape == (12, 16, 3) and box[6, 8, 2] > box[6, 8, 0] + 20  # the blue box in the centre
    # --mesh without a torch.distributed world: the one-rank mesh, the same
    # bytes as the render above
    assert main(["render", "--scene", "baseline_spheres", *args, "--out", str(tmp_path / "mesh"),
                 "--format", "ppm", "--chunk-size", "100", "--mesh"]) == 0
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "mesh" / "aces.ppm")),
                                  read_ppm(str(out / "aces.ppm")))
    # the fault-tolerant bands (parallel/fault.py), a fault injected into
    # the first band's first attempt: one retry, and render_hdr's frame
    real, calls, events = fault.render_pixels, [], []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected device fault")
        return real(*a, **k)

    fault.render_pixels = flaky
    try:
        banded = fault.render_hdr_faulttolerant(scene, cam, RenderConfig(chunk_size=100), seed=0, tile_rows=4,
                                                max_retries=2, on_event=lambda e, f: events.append((e, f)))
    finally:
        fault.render_pixels = real
    assert [e for e, _ in events] == ["band_retry"] + ["band_ok"] * 4, events
    assert events[0][1]["error"] == "injected device fault" and events[1][1]["attempt"] == 1
    assert torch.equal(banded, hdr)

    assert main(["aov", "--scene", "glass", *args, "--out", str(tmp_path / "aov")]) == 0
    assert sorted(os.listdir(tmp_path / "aov")) == ["albedo.png", "depth.png", "hit.png", "normal.png"]

    ckpt = tmp_path / "fit.pt"
    capsys.readouterr()
    assert main(["fit", "--scene", "baseline_spheres", "--width", "16", "--height", "16", "--spp", "1",
                 "--device", "cpu", "--steps", "3", "--out", str(tmp_path / "fit"),
                 "--checkpoint", str(ckpt)]) == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("fit: loss")][0]
    first, last = (float(x) for x in line.split()[2:5:2])
    assert last < first, line
    assert sorted(os.listdir(tmp_path / "fit")) == ["fitted.png", "initial.png", "target.png"]
    state = restore_checkpoint(str(ckpt), device="cpu")
    assert state["step"] == 3 and "spheres.materials.color" in state["params"]

    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-m", "raytracingengine_tpu_torch.cli", "aov", "--width", "8",
                           "--height", "8", "--device", "cpu", "--format", "ppm", "--out",
                           str(tmp_path / "m")], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert sorted(os.listdir(tmp_path / "m")) == ["albedo.ppm", "depth.ppm", "hit.ppm", "normal.ppm"]

    logger = MetricsLogger(str(tmp_path / "metrics.jsonl"))
    fit_callback(logger)(2, 0.5)
    logger.log("render", width=16, height=12, spp=2, seconds=0.25, rays_per_s=16 * 12 * 2 / 0.25)
    logger.close()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "fit_step" and lines[0]["loss"] == 0.5 and lines[1]["rays_per_s"] == 1536.0
    aovs = checked(render_aovs)(scene, cam)
    assert_finite(aovs, "aovs")
    tree = {"ok": torch.ones(2), "grads": [torch.zeros(1), torch.tensor([1.0, float("nan"), float("inf")])]}
    with pytest.raises(FloatingPointError, match=r"grads\[1\] has 2 non-finite"):
        assert_finite(tree)
    with pytest.raises(FloatingPointError, match="has 1 non-finite"):
        checked(torch.log)(torch.tensor([-1.0, 1.0]))
