"""PyTorch port, scene state: the port's scenes, FlatScene and kernel tables
are the JAX package's, float for float.

The JAX scenes are carried across as numpy leaves (convert.py); the port's
own builders must produce the same tensors, and flatten_scene and
pack_scene_tables must agree field by field with exact float32 equality.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytracingengine_tpu.core import vecmath as jax_vm
from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.geometry.materials import Material as JaxMaterial
from raytracingengine_tpu.geometry.materials import Materials as JaxMaterials
from raytracingengine_tpu.kernels.chain_trace import pack_scene_tables as jax_pack
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.materials import Material, Materials
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "head_box": dict(fn="head_box_scene", kw=dict(width=16, height=12, spp=1)),
    "head_box_pad8": dict(fn="head_box_scene", kw=dict(width=16, height=12, spp=1, pad_multiple=8)),
    "baseline_spheres": dict(fn="baseline_sphere_scene", kw=dict(width=16, height=12, n_lights=2)),
    "baseline_spheres_pad8": dict(
        fn="baseline_sphere_scene", kw=dict(width=16, height=12, n_lights=2, pad_multiple=8)
    ),
    "glass_sphere": dict(fn="glass_sphere_scene", kw=dict(width=16, height=12, spp=1)),
    "stress": dict(fn="stress_scene", kw=dict(width=16, height=12)),
    # unpadded, past the staged route's limit (tests/test_torch_staged.py)
    "stress_338": dict(fn="stress_scene", kw=dict(n_spheres=338, pad_multiple=None, width=16, height=12)),
}


def jax_leaves(tree) -> dict[str, np.ndarray]:
    """Pytree -> {dotted field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def torch_leaves(obj, prefix="") -> dict[str, np.ndarray]:
    """Dataclass of tensors -> {dotted field path: numpy array}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(torch_leaves(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.numpy()
    return out


def assert_same_leaves(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = ours[k], ref[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def build_pair(name):
    spec = SCENES[name]
    j_scene, j_cam = getattr(jax_builders, spec["fn"])(**spec["kw"])
    t_scene, t_cam = getattr(builders, spec["fn"])(**spec["kw"], device="cpu")
    return (j_scene, j_cam), (t_scene, t_cam)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_builders_match_jax(name):
    (j_scene, j_cam), (t_scene, t_cam) = build_pair(name)
    assert_same_leaves(torch_leaves(t_scene), jax_leaves(j_scene))
    assert t_scene.has_transparency == j_scene.has_transparency
    assert_same_leaves(torch_leaves(t_cam), jax_leaves(j_cam))
    assert (t_cam.width, t_cam.height, t_cam.spp) == (j_cam.width, j_cam.height, j_cam.spp)
    # convert.py carries the JAX state across unchanged
    carried = scene_from_numpy(
        jax_leaves(j_scene), has_transparency=j_scene.has_transparency, device="cpu"
    )
    assert_same_leaves(torch_leaves(carried), jax_leaves(j_scene))
    cam = camera_from_numpy(
        jax_leaves(j_cam), width=j_cam.width, height=j_cam.height, spp=j_cam.spp,
        device="cpu",
    )
    assert_same_leaves(torch_leaves(cam), jax_leaves(j_cam))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_and_tables_match_jax(name):
    (j_scene, _), (t_scene, _) = build_pair(name)
    j_flat = jax_flatten(j_scene)
    t_flat = flatten_scene(t_scene)
    assert_same_leaves(torch_leaves(t_flat), jax_leaves(j_flat))
    assert (t_flat.n_spheres, t_flat.n_planes, t_flat.n_triangles) == (
        j_flat.n_spheres, j_flat.n_planes, j_flat.n_triangles,
    )
    tables = pack_scene_tables(t_flat)
    for ours, ref in zip(tables.tensors(), jax_pack(j_flat)):
        ref = np.asarray(ref)
        assert ours.dtype == torch.float32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours.numpy(), ref)
    assert (tables.n_spheres, tables.n_planes, tables.n_triangles, tables.n_lights) == (
        j_flat.n_spheres, j_flat.n_planes, j_flat.n_triangles, j_flat.n_lights,
    )


def test_padded_slots_are_degenerate():
    scene, _ = builders.baseline_sphere_scene(
        width=8, height=8, n_lights=2, pad_multiple=8, device="cpu"
    )
    t = pack_scene_tables(flatten_scene(scene))
    assert t.n_spheres == 8 and t.n_lights == 8
    assert (t.sph[3, 3:] == -1.0).all()  # r^2 = -1: never hits
    assert (t.pl[:3, 1:] == 0.0).all()  # n = 0: never hits
    assert (t.light[:3, 2:] == 1.0e7).all() and (t.light[3:6, 2:] == 0.0).all()
    head, _ = builders.head_box_scene(width=8, height=8, device="cpu")
    h = pack_scene_tables(flatten_scene(head))
    assert h.n_spheres == 0 and h.sph.shape == (4, 1) and (h.sph == 0).all()


@pytest.mark.parametrize("jittered", [False, True])
def test_camera_rays_match_jax(jittered):
    (_, j_cam), (_, t_cam) = build_pair("head_box")
    px, py = t_cam.pixel_grid()
    jpx, jpy = j_cam.pixel_grid()
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    jit = None
    if jittered:
        jit = np.random.default_rng(0).random((px.shape[0], 2), dtype=np.float32)
    o, d = t_cam.rays_for_pixels(px, py, None if jit is None else torch.from_numpy(jit))
    jo, jd = j_cam.rays_for_pixels(jpx, jpy, jit)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-7)


def test_port_imports_no_jax():
    """The port and chip_smoke.py run where JAX is not installed: every
    module of the port, the oracle, profiling and parallel/ included."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import raytracingengine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raytracingengine_tpu.'))"
        " or m == 'raytracingengine_tpu']\n"
        "assert not bad, bad\n"
        "for m in ('kernels.wavefront_trace', 'golden.reference', 'utils.profiling', 'parallel.mesh',\n"
        "          'parallel.multihost', 'parallel.sharded', 'parallel.fault', 'native_bridge'):\n"
        "    assert 'raytracingengine_tpu_torch.' + m in sys.modules, m\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


@pytest.mark.parametrize("fn", ["dot", "cross", "length", "normalize", "reflect", "clamp01"])
def test_vecmath_matches_jax(fn):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 3)).astype(np.float32) * 3.0
    b = rng.normal(size=(64, 3)).astype(np.float32)
    a[0] = 0.0  # safe normalize: the zero vector maps to zero
    a[1] = [1e-13, 0.0, 0.0]
    args = (a,) if fn in ("length", "normalize", "clamp01") else (a, b)
    ours = getattr(vm, fn)(*(torch.from_numpy(x) for x in args)).numpy()
    ref = np.asarray(getattr(jax_vm, fn)(*args))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    if fn == "normalize":
        assert (ours[:2] == 0.0).all()


def test_materials_stack_and_concat_match_jax():
    specs = [dict(color=(0.1, 0.2, 0.3), specular=0.5), dict(shininess=0.128), {}]
    ours = Materials.concat([Materials.stack([Material(**s)], device="cpu") for s in specs] + [Materials.stack([], device="cpu")])
    ref = JaxMaterials.concat([JaxMaterials.stack([JaxMaterial(**s)]) for s in specs])
    assert len(ours) == 3
    assert_same_leaves(torch_leaves(ours), jax_leaves(ref))
