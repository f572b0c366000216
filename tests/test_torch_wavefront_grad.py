"""PyTorch port, the glass training path: the taped-DFS adjoint
(kernels/wavefront_grad.py) behind wavefront_trace_fused, against jax.grad
of the JAX package's integrate_wavefront on the CPU.

On a CPU tensor the wrapper runs its plain version, wavefront_grad_plain,
so every gradient here goes wavefront_trace_fused -> WavefrontTraceFused
-> wavefront_grad -> wavefront_grad_plain. The reference is XLA autodiff of
the fixed-trip integrate_wavefront (differentiable=True), the function the
JAX package's tests/test_wavefront_grad.py holds its fused adjoint to, with
its four configurations; each reference is jitted once per module, never
an interpret-mode Pallas kernel. Budgets: loss rtol 1e-5; each float scene
leaf parity.grad_leaf_mismatches (rtol 2e-3, atol 2e-4 + 1e-3 * max|ref
leaf|: tests/test_wavefront_grad.py's budget, fp32 sums over rays in other
orders); ray origins atol 1e-4 * max|ref|; ray directions on their part
tangential to the ray (the kernels' sky reads the stored direction's y,
the integrator normalises it first, which changes only the radial part).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.core.camera import Camera as JaxCamera
from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.geometry.materials import Material as JaxMaterial
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_wavefront as jax_integrate_wavefront
from raytracingengine_tpu.scene import SceneBuilder as JaxSceneBuilder
from raytracingengine_tpu.scenes import assets as jax_assets
from raytracingengine_tpu.scenes import builders as jax_builders
import raytracingengine_tpu_torch.kernels.wavefront_grad as wg
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.inverse import combine, make_train_step, partition
from raytracingengine_tpu_torch.kernels.chain_grad import MAX_PRIMS
from raytracingengine_tpu_torch.kernels.chain_trace import pack_forward_tables_perm, pack_scene_tables
from raytracingengine_tpu_torch.parity import direction_cot_ok, grad_leaf_mismatches, origin_cot_ok
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_wavefront
from raytracingengine_tpu_torch.render.pipeline import REPLAY_WARNING, render_hdr, render_rays
from raytracingengine_tpu_torch.scene import SceneBuilder
from raytracingengine_tpu_torch.scenes import assets, builders

torch.set_num_threads(2)


def pane_scene(pkg_builder, pkg_material, **build_kw):
    """A floor lit through a pane of transparency exactly 1.0 (ior 1), and
    an opaque sphere: every shadow ray from the floor crosses the pane, so
    the march multiplies T by clip(1.0) = 1.0 and T itself ends at 1.0."""
    b = pkg_builder()
    b.add_plane((0, -2, 0), (0, 1, 0), pkg_material(color=(0.8, 0.8, 0.8)))
    b.add_plane((0, 2, 0), (0, -1, 0),
                pkg_material(color=(0.3, 0.6, 0.9), transparency=1.0, refractive_index=1.0))
    b.add_sphere((0.5, -1.0, 6.0), 1.0, pkg_material(color=(0.9, 0.4, 0.1)))
    b.add_light((-1.0, 6.0, 2.0), (1, 1, 1), 60.0)
    return b.build(**build_kw)


def jax_pane(size):
    cam = JaxCamera.create((0, 0, -8), focal=float(size), width=size, height=size, near=0.0,
                           far=100.0, spp=1)
    return pane_scene(JaxSceneBuilder, JaxMaterial), cam


def port_pane(size):
    return pane_scene(SceneBuilder, Material, device="cpu"), None


#: name -> (JAX scene and camera, port scene, config, camera nudge): the
#: four configurations of tests/test_wavefront_grad.py:75-117, and the pane.
CASES = {
    "glass_binary": (lambda: jax_builders.glass_sphere_scene(width=8, height=8),
                     lambda: builders.glass_sphere_scene(8, 8, device="cpu"),
                     dict(shadow_mode="binary", max_depth=4, wavefront_budget=40), None),
    "glass_march": (lambda: jax_builders.glass_sphere_scene(width=8, height=8),
                    lambda: builders.glass_sphere_scene(8, 8, device="cpu"),
                    dict(shadow_mode="march", max_depth=4, wavefront_budget=40), None),
    "deep_tir": (lambda: jax_builders.glass_sphere_scene(width=6, height=6),
                 lambda: builders.glass_sphere_scene(6, 6, device="cpu"),
                 dict(shadow_mode="march", max_depth=6, wavefront_budget=100), None),
    "head_box_wavefront": (lambda: jax_builders.head_box_scene(width=8, height=8, spp=1),
                           lambda: builders.head_box_scene(width=8, height=8, spp=1, device="cpu"),
                           dict(shadow_mode="binary", max_depth=3, wavefront_budget=24,
                                mode="wavefront"), (0.013, 0.007, 0.0)),
    "pane_tau_one": (lambda: jax_pane(8), lambda: port_pane(8),
                     dict(shadow_mode="march", max_depth=4, wavefront_budget=40), None),
    # 144 triangles: culled tables for the forward, linear ones for the adjoint
    "glass_mesh_147": (lambda: (glass_mesh_scene(JaxSceneBuilder, JaxMaterial, jax_assets, ni=3, nj=36),
                                jax_builders.glass_sphere_scene(width=6, height=6)[1]),
                       lambda: (glass_mesh_scene(SceneBuilder, Material, assets, ni=3, nj=36,
                                                 device="cpu"), None),
                       dict(shadow_mode="march", max_depth=3, wavefront_budget=12), None),
}


def glass_mesh_scene(pkg_builder, pkg_material, pkg_assets, ni=6, nj=52, **build_kw):
    """The glass sphere scene with a transparent bumpy mesh of nj * (2 ni - 2)
    triangles in front of the glass sphere: by default 520, 523 primitives,
    past the glass adjoint's 512."""
    b = pkg_builder()
    b.add_sphere((0.0, 0.0, 5.0), 1.5,
                 pkg_material(color=(1, 1, 1), transparency=0.9, refractive_index=1.5))
    b.add_sphere((1.5, -0.8, 9.0), 1.0, pkg_material(color=(0.9, 0.4, 0.1)))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), pkg_material(color=(0.8, 0.8, 0.8)))
    verts, idx = pkg_assets.bumpy_sphere_mesh(radius=1.2, ni=ni, nj=nj)
    b.add_model(verts, idx, pkg_material(color=(0.6, 0.9, 0.7), transparency=0.7, refractive_index=1.3),
                translation=(-0.3, 0.2, 3.0))
    b.add_light((-3.0, 5.0, -1.0), (1, 1, 1), 60.0)
    return b.build(**build_kw)


#: Past the glass adjoint's scope: the route of JAX's _wavefront_bwd there.
PAST_SCOPE = {
    "glass_mesh_523": (lambda: (glass_mesh_scene(JaxSceneBuilder, JaxMaterial, jax_assets),
                                jax_builders.glass_sphere_scene(width=6, height=6)[1]),
                       lambda: (glass_mesh_scene(SceneBuilder, Material, assets, device="cpu"), None),
                       dict(shadow_mode="binary", max_depth=3, wavefront_budget=12), None),
}


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """-> (rays o, d, image, float scene-leaf grads, d_o, d_d) of sum(img^2)
    through XLA autodiff of the fixed-trip integrate_wavefront."""
    make_jax, _, cfg_kw, nudge = {**CASES, **PAST_SCOPE}[name]
    scene, cam = make_jax()
    if nudge is not None:
        cam = dataclasses.replace(cam, position=cam.position + jnp.asarray(nudge))
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    cfg = JaxConfig(differentiable=True, **cfg_kw)

    def img_and_grads(s, oo, dd):  # one compile for the forward and the VJP
        img, vjp = jax.vjp(lambda s, oo, dd: jax_integrate_wavefront(jax_flatten(s), oo, dd, cfg), s, oo, dd)
        return img, vjp(2.0 * img)

    # XLA's backend optimisations take half the compile time of these
    # one-shot references and nothing of their accuracy.
    compiled = jax.jit(img_and_grads).lower(scene, o, d).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    img, (g_scene, g_o, g_d) = compiled(scene, o, d)
    grads = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}
    return np.array(o), np.array(d), np.asarray(img), grads, np.asarray(g_o), np.asarray(g_d)


def port_grads(name):
    """sum(img^2) through wavefront_trace_fused on the CPU -> (loss, leaf
    grads, d_o, d_d, params). The tables are render_hdr's: culled past
    TRI_BLOCK triangles (the forward scans them, the adjoint their linear
    tables), else linear."""
    _, make_port, cfg_kw, _ = CASES[name]
    o_np, d_np = jax_reference(name)[:2]
    scene, _ = make_port()
    params, static = partition(scene)
    o = torch.from_numpy(o_np).requires_grad_(True)
    d = torch.from_numpy(d_np).requires_grad_(True)
    tables = pack_forward_tables_perm(flatten_scene(combine(params, static)))
    img = wg.wavefront_trace_fused(tables, o, d, RenderConfig(use_pallas=True, **cfg_kw))
    loss = (img * img).sum()
    loss.backward()
    # a leaf the path never reads gets no .grad; JAX's gradient there is zeros
    grads = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
             for k, p in params.items()}
    return float(loss.detach()), grads, o.grad.numpy(), d.grad.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_glass_grads_match_jax(name):
    """Every float scene leaf, transparency and refractive index included,
    and the ray cotangents, against jax.grad of integrate_wavefront. The
    pane pins the march's clip rule: its transparency 1.0 and T = 1.0 each
    take jnp.clip's subgradient of 0.5."""
    _, d, img_ref, ref, go_ref, gd_ref = jax_reference(name)
    loss, ours, go, gd = port_grads(name)
    np.testing.assert_allclose(loss, float((img_ref.astype(np.float64) ** 2).sum()), rtol=1e-5)
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors
    ok, err, bound = origin_cot_ok(go, go_ref)
    assert ok, (err, bound)
    ok, p99, mx, scale = direction_cot_ok(gd, gd_ref, d)
    assert ok, (p99, mx, scale)
    if name in ("glass_march", "deep_tir"):
        assert np.abs(ours["spheres.materials.transparency"]).max() > 1e-4
        assert np.abs(ours["spheres.materials.refractive_index"]).max() > 1e-4
    if name == "pane_tau_one":
        assert np.abs(ours["planes.materials.transparency"][1]) > 1e-4


def test_plain_matches_port_integrator_autograd():
    """wavefront_grad_plain against torch autograd of the port's own
    fixed-trip integrate_wavefront (no JAX), glass sphere 6x6, binary
    shadows, depth 3: the same leaf budget."""
    cfg = RenderConfig(shadow_mode="binary", max_depth=3, wavefront_budget=16)
    scene, cam = builders.glass_sphere_scene(6, 6, device="cpu")
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    params, static = partition(scene)
    img = integrate_wavefront(flatten_scene(combine(params, static)), o, d,
                              dataclasses.replace(cfg, differentiable=True))
    (img * img).sum().backward()
    ref = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for k, p in params.items()}
    params, static = partition(scene)
    img = wg.wavefront_trace_fused(pack_scene_tables(flatten_scene(combine(params, static))),
                                   o.contiguous(), d, cfg)
    (img * img).sum().backward()
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors


def test_glass_train_step_cpu():
    """make_train_step on the glass sphere at 8x8 with use_pallas=True:
    the kernel route (plain versions on the CPU), SGD on mean(img^2), the
    camera focal trained too; finite, and the glass sphere's transparency
    and refractive index get gradients."""
    scene, cam = builders.glass_sphere_scene(8, 8, device="cpu")
    params, static = partition(scene)
    focal = cam.focal.clone().requires_grad_(True)
    cam = dataclasses.replace(cam, focal=focal)
    cfg = RenderConfig(use_pallas=True, max_depth=4, wavefront_budget=40)
    opt = torch.optim.SGD([*params.values(), focal], lr=1e-6)
    step = make_train_step(cam, cfg, opt, loss_fn=lambda img, _t: (img * img).mean())
    launches = (wg.wavefront_grad.launches,)
    losses = []
    for _ in range(2):
        loss, grads = step(params, static, None)
        losses.append(float(loss))
    assert (wg.wavefront_grad.launches,) == launches  # CPU: no kernel launch
    assert np.isfinite(losses).all()
    assert all(g is None or torch.isfinite(g).all() for g in grads.values())
    assert float(grads["spheres.materials.transparency"][0]) != 0.0
    assert float(grads["spheres.materials.refractive_index"][0]) != 0.0
    assert float(focal.grad) != 0.0


def test_glass_grad_above_adjoint_scope_raises():
    """Past the glass adjoint's 512 primitives (a glass scene with a
    520-triangle transparent mesh in front of the glass sphere, 6x6 rays,
    binary shadows): the route of
    JAX's _wavefront_bwd. wavefront_trace_fused itself raises ValueError
    there; render_rays' gradient raises REPLAY_WARNING and is autograd of
    integrate_wavefront's replay, held to jax.grad of JAX's
    integrate_wavefront (differentiable=True, the same budget) as
    test_glass_grads_match_jax holds the adjoint. The forward is the
    wavefront_trace kernel's (its plain version here)."""
    name = "glass_mesh_523"
    _, make_port, cfg_kw, _ = PAST_SCOPE[name]
    o_np, d_np, img_ref, ref, go_ref, gd_ref = jax_reference(name)
    scene, _ = make_port()
    cfg = RenderConfig(use_pallas=True, **cfg_kw)
    params, static = partition(scene)
    flat = flatten_scene(combine(params, static))
    assert flat.n_primitives == 523 > MAX_PRIMS
    o = torch.from_numpy(o_np).requires_grad_(True)
    d = torch.from_numpy(d_np).requires_grad_(True)
    with pytest.raises(ValueError, match="at most 512 primitives"):
        wg.wavefront_trace_fused(pack_scene_tables(flat), o, d, cfg)
    with pytest.warns(UserWarning, match="fixed-trip replay"):
        img = render_rays(combine(params, static), o, d, cfg)
        loss = (img * img).sum()
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float((img_ref.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors
    assert np.abs(ours["triangles.materials.transparency"]).max() > 1e-4
    ok, err, bound = origin_cot_ok(o.grad.numpy(), go_ref)
    assert ok, (err, bound)
    ok, p99, mx, scale = direction_cot_ok(d.grad.numpy(), gd_ref, d_np)
    assert ok, (p99, mx, scale)
    assert REPLAY_WARNING.startswith("wavefront_trace backward runs autograd")
