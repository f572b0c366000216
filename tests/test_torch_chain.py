"""PyTorch port, chain trace: the plain version of the chain kernel against
the JAX package's chain integrator and against its Pallas kernel.

Tolerance, "the seam budget": elementwise HDR atol 1e-4, except that at
most max(4, 1e-3 * pixels) pixels may exceed it as closest-hit seam ties.
Each test prints the count of such pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import raytracingengine_tpu.kernels.chain_trace as jct
from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_chain
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.kernels.chain_trace import (
    chain_trace,
    pack_scene_tables,
    trace_chain_plain,
)
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)
JAX_CFG = JaxConfig(shadow_mode="binary")

SCENES = {
    "head_box": ("head_box_scene", {}),
    "head_box_pad8": ("head_box_scene", {"pad_multiple": 8}),
    "baseline_spheres": ("baseline_sphere_scene", {"n_lights": 2}),
    "baseline_spheres_pad8": ("baseline_sphere_scene", {"n_lights": 2, "pad_multiple": 8}),
}


def port_trace(fn, size, cfg=CFG, **kw):
    scene, cam = getattr(builders, fn)(width=size, height=size, spp=1, device="cpu", **kw)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    tables = pack_scene_tables(flatten_scene(scene))
    return trace_chain_plain(tables, o, d, cfg).numpy()


def check(name, ours, ref):
    report = seam_budget(ours, ref)
    print(f"{name}: {report}")
    assert np.isfinite(ours).all()
    assert report.ok, f"{name}: {report}"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_chain_plain_matches_jax_render(name):
    """(b) the plain chain trace vs JAX render_hdr(mode='chain') at 32x32."""
    fn, kw = SCENES[name]
    ours = port_trace(fn, 32, **kw)
    j_scene, j_cam = getattr(jax_builders, fn)(width=32, height=32, spp=1, **kw)
    render = jit_o0(lambda s, c: jax_render_hdr(s, c, JAX_CFG, mode="chain"))
    ref = np.asarray(render(j_scene, j_cam)).reshape(-1, 3)
    check(name, ours, ref)


@pytest.mark.parametrize("max_depth,min_weight", [(0, 1e-8), (1, 1e-8), (3, 1e-8), (10, 0.0)])
def test_chain_plain_depth_and_pruning(max_depth, min_weight):
    """(b) depth limits (sky on exhaustion) and min_weight pruning."""
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, max_depth=max_depth,
                       min_weight=min_weight)
    jcfg = JaxConfig(shadow_mode="binary", max_depth=max_depth, min_weight=min_weight)
    ours = port_trace("head_box_scene", 16, cfg)
    j_scene, j_cam = jax_builders.head_box_scene(width=16, height=16, spp=1)
    o, d = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    ref = np.asarray(jit_o0(lambda: integrate_chain(jax_flatten(j_scene), o, d, jcfg))())
    check(f"depth={max_depth} min_weight={min_weight}", ours, ref)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run Pallas kernels in interpret mode, as tests/test_pallas_kernel.py."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jct.pl, "pallas_call", patched)


def test_chain_plain_matches_pallas_kernel(interpret_mode):
    """(c) one 16x16 head box tile vs chain_trace_pallas in interpret mode,
    both fed the same rays."""
    j_scene, j_cam = jax_builders.head_box_scene(width=16, height=16, spp=1)
    o, d = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    ref = np.asarray(jct.chain_trace_pallas(jax_flatten(j_scene), o, d, JAX_CFG))
    scene, _ = builders.head_box_scene(width=16, height=16, spp=1, device="cpu")
    tables = pack_scene_tables(flatten_scene(scene))
    ours = chain_trace(
        tables, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)), CFG
    ).numpy()
    check("chain_trace_pallas", ours, ref)


def test_chain_plain_on_seeded_rays():
    """Arbitrary rays (not camera rays): seeded origins inside the box and
    random directions, incl. rays that start on the far side of the mesh."""
    rng = np.random.default_rng(7)
    o = rng.uniform(-12.0, 12.0, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j_scene, _ = jax_builders.head_box_scene(width=8, height=8, spp=1)
    ref = np.asarray(jit_o0(
        lambda: integrate_chain(jax_flatten(j_scene), jnp.asarray(o), jnp.asarray(d), JAX_CFG)
    )())
    scene, _ = builders.head_box_scene(width=8, height=8, spp=1, device="cpu")
    ours = trace_chain_plain(
        pack_scene_tables(flatten_scene(scene)), torch.from_numpy(o), torch.from_numpy(d), CFG
    ).numpy()
    check("seeded rays", ours, ref)
