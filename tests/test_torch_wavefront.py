"""PyTorch port, the glass path: the transmittance march, the wavefront
integrator and the plain versions of the wavefront kernels against the JAX
package on the CPU.

References are the JAX package's XLA functions (transmittance_hard,
integrate_wavefront, render_hdr), never its interpret-mode Pallas kernels,
and each is computed once per module. Budgets (raytracingengine_tpu_torch/
parity.py): HDR images under the seam budget (elementwise atol 1e-4, at
most max(4, 1e-3 * pixels) pixels beyond it, for rays that graze an edge
or the TIR threshold and take the other branch); transmittance atol 1e-6;
gradients rtol 1e-5 (one product) or the leaf budget of grad_leaf_mismatches
(fp32 sums over rays in other orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.geometry.materials import Material as JaxMaterial
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_wavefront as jax_integrate_wavefront
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.render.shading import transmittance_hard as jax_transmittance_hard
from raytracingengine_tpu.scene import SceneBuilder as JaxSceneBuilder
from raytracingengine_tpu.scenes import builders as jax_builders
import raytracingengine_tpu_torch.kernels.wavefront_grad as wg
import raytracingengine_tpu_torch.kernels.wavefront_trace as wt
import raytracingengine_tpu_torch.render.pipeline as pipeline
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.kernels.chain_trace import (
    TRI_BLOCK,
    TRI_GROUP,
    pack_forward_tables_perm,
    pack_scene_tables,
)
from raytracingengine_tpu_torch.kernels.spp_trace import mean_over_samples
from raytracingengine_tpu_torch.parity import grad_leaf_mismatches, seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain, integrate_wavefront
from raytracingengine_tpu_torch.render.shading import transmittance_hard
from raytracingengine_tpu_torch.scene import SceneBuilder
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

SHADOWS = ["binary", "march"]


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


# ---------------------------------------------------------------------------
# The transmittance march on two transparent panes and an opaque sphere
# (tests/test_shadows.py:23-32), built in both packages
# ---------------------------------------------------------------------------


def pane_scene(pkg_builder, pkg_material, **build_kw):
    b = pkg_builder()
    glass = pkg_material(color=(1, 1, 1), transparency=0.5, refractive_index=1.0)
    half = pkg_material(color=(1, 1, 1), transparency=0.25, refractive_index=1.0)
    b.add_plane((0, 0, 3), (0, 0, -1), glass)
    b.add_plane((0, 0, 6), (0, 0, -1), half)
    b.add_sphere((0, 0, 20), 1.0, pkg_material(color=(1, 0, 0)))  # opaque, far
    b.add_light((0, 0, 30), (1, 1, 1), 10.0)
    return b.build(**build_kw)


#: Along +z from the origin: past both panes, past the first only, into the
#: opaque sphere, and a lane that is not marched.
PANE_MAX_DIST = np.array([10.0, 4.0, 50.0, 10.0], np.float32)
PANE_ACTIVE = np.array([True, True, True, False])
PLANE_TAU = "planes.materials.transparency"


def port_pane_march(cfg, params=None):
    static = pane_scene(SceneBuilder, Material, device="cpu")
    scene = static if params is None else combine(params, partition(static)[1])
    n = PANE_MAX_DIST.size
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    return transmittance_hard(
        flatten_scene(scene), torch.zeros((n, 3)), d, torch.from_numpy(PANE_MAX_DIST),
        torch.from_numpy(PANE_ACTIVE), cfg,
    )


@functools.partial(jax.jit, static_argnums=1)
def jax_pane_march(tau, cfg):
    """The JAX march on the pane lanes, with the planes' transparency `tau`."""
    scene = pane_scene(JaxSceneBuilder, JaxMaterial)
    n = PANE_MAX_DIST.size
    o, d = jnp.zeros((n, 3)), jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (n, 1))
    mats = dataclasses.replace(scene.planes.materials, transparency=tau)
    s = dataclasses.replace(scene, planes=dataclasses.replace(scene.planes, materials=mats))
    return jax_transmittance_hard(
        jax_flatten(s), o, d, jnp.asarray(PANE_MAX_DIST), jnp.asarray(PANE_ACTIVE), cfg
    )


PANE_TAU = np.array([0.5, 0.25], np.float32)


def test_transmittance_hard_matches_jax():
    """Both panes 0.5 * 0.25, the first only 0.5, into the sphere 0; an
    inactive lane stays 1."""
    ours = port_pane_march(RenderConfig()).numpy()
    ref = np.asarray(jax_pane_march(jnp.asarray(PANE_TAU), JaxConfig()))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, [0.125, 0.5, 0.0, 1.0], rtol=0, atol=1e-6)


def glass_scene(size, spp=1, pkg=builders, **kw):
    return pkg.glass_sphere_scene(width=size, height=size, spp=spp, **kw)


def glass_mesh_scene(size, spp=1, pkg=builders, ni=3, nj=33, **kw):
    """The glass sphere scene with dense_mesh_scene's bumpy mesh (ni x nj:
    132 triangles by default, just past TRI_BLOCK, one group of 8 culling
    blocks) made transparent (0.7, ior 1.3), in either package."""
    xp = jnp if pkg is jax_builders else torch
    glass, cam = glass_scene(size, spp, pkg, **kw)
    mesh = pkg.dense_mesh_scene(width=size, height=size, spp=spp, ni=ni, nj=nj, **kw)[0].triangles
    m = mesh.materials
    mats = dataclasses.replace(m, transparency=xp.full_like(m.transparency, 0.7),
                               refractive_index=xp.full_like(m.refractive_index, 1.3))
    return dataclasses.replace(glass, triangles=dataclasses.replace(mesh, materials=mats)), cam


#: The wavefront scenes of the port-vs-JAX cases.
GLASS_SCENES = {"sphere": glass_scene, "mesh": glass_mesh_scene}


@pytest.mark.parametrize("fn", ["transmittance_hard", "integrate_wavefront"])
def test_fixed_trip_form_equals_while_form(fn):
    """differentiable=True runs every step (march) or every budget
    iteration (DFS); an idle lane adds nothing, so the values are equal."""
    if fn == "transmittance_hard":
        a = port_pane_march(RenderConfig()).numpy()
        b = port_pane_march(RenderConfig(differentiable=True)).numpy()
    else:
        scene, cam = glass_scene(8, device="cpu")
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        cfg = RenderConfig(shadow_mode="binary", wavefront_budget=64)
        a = integrate_wavefront(flatten_scene(scene), o, d, cfg).numpy()
        b = integrate_wavefront(flatten_scene(scene), o, d, dataclasses.replace(cfg, differentiable=True)).numpy()
    np.testing.assert_array_equal(a, b)


def test_transmittance_grad_matches_jax():
    """d sum(T) / d plane transparency through the fixed-trip march: the
    other pane's transparency on the lane through both (rtol 1e-5)."""
    params, _ = partition(pane_scene(SceneBuilder, Material, device="cpu"))
    port_pane_march(RenderConfig(differentiable=True), params).sum().backward()
    ref = jax.jit(jax.grad(lambda t: jnp.sum(jax_pane_march(t, JaxConfig(differentiable=True)))))(
        jnp.asarray(PANE_TAU))
    ours = params[PLANE_TAU].grad.numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours, [0.25 + 1.0, 0.5], rtol=1e-5)  # lanes 0 and 1; lane 0 only


# ---------------------------------------------------------------------------
# The wavefront trace on the glass sphere scene
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_glass(shadow_mode, size=16, scene_name="sphere"):
    """-> (rays o, d, JAX integrate_wavefront image) of the GLASS_SCENES
    scene."""
    scene, cam = GLASS_SCENES[scene_name](size, pkg=jax_builders)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    cfg = JaxConfig(shadow_mode=shadow_mode)
    img = jit_o0(lambda s, o, d: jax_integrate_wavefront(jax_flatten(s), o, d, cfg))(scene, o, d)
    return np.array(o), np.array(d), np.asarray(img)


def port_glass(shadow_mode, size=16, scene_name="sphere"):
    scene, _ = GLASS_SCENES[scene_name](size, device="cpu")
    o, d, ref = jax_glass(shadow_mode, size, scene_name)
    cfg = RenderConfig(shadow_mode=shadow_mode, use_pallas=True)
    return scene, torch.from_numpy(o), torch.from_numpy(d), cfg, ref


@pytest.mark.parametrize("shadow_mode", SHADOWS)
def test_integrate_wavefront_matches_jax(shadow_mode):
    scene, o, d, cfg, ref = port_glass(shadow_mode)
    ours = integrate_wavefront(flatten_scene(scene), o, d, cfg).numpy()
    report = seam_budget(ours, ref)
    print(f"{shadow_mode}: {report}")
    assert np.isfinite(ours).all() and report.ok, report


@pytest.mark.parametrize("scene_name, shadow_mode", [
    pytest.param("sphere", m, id=m) for m in SHADOWS] + [
    pytest.param("mesh", m, id=f"mesh-{m}") for m in SHADOWS])
def test_trace_wavefront_plain_matches_jax(scene_name, shadow_mode):
    """The plain glass trace against JAX's integrate_wavefront (16x16 on the
    glass sphere). On the glass mesh (132 triangles, 8x8) the culled tables'
    trace (every scan block by block, the lexicographic (t, original index)
    winner) equals the linear tables' bit for bit, and both meet JAX."""
    size = 16 if scene_name == "sphere" else 8
    scene, o, d, cfg, ref = port_glass(shadow_mode, size, scene_name)
    flat = flatten_scene(scene)
    tables = pack_scene_tables(flat)
    ours = wt.trace_wavefront_plain(tables, o, d, cfg).numpy()
    if scene_name == "mesh":
        culled = pack_forward_tables_perm(flat)
        assert flat.n_triangles > TRI_BLOCK and culled.culled and culled.n_blocks == TRI_GROUP
        np.testing.assert_array_equal(wt.trace_wavefront_plain(culled, o, d, cfg).numpy(), ours)
    report = seam_budget(ours, ref)
    print(f"{scene_name} {shadow_mode}: {report}")
    assert np.isfinite(ours).all() and report.ok, report


def test_wavefront_equals_chain_on_opaque_scene():
    """On the head box (no transparency) the DFS is the reflection chain."""
    scene, cam = builders.head_box_scene(width=12, height=12, spp=1, device="cpu")
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    flat = flatten_scene(scene)
    cfg = RenderConfig()
    np.testing.assert_allclose(
        integrate_wavefront(flat, o, d, cfg).numpy(), integrate_chain(flat, o, d, cfg).numpy(),
        rtol=0, atol=1e-6,
    )


def test_wavefront_spp_plain_with_given_jitter_matches_jax():
    """spp=4 at 12x12 with one seeded jitter array [spp, R, 2]: the mean of
    the JAX integrate_wavefront calls on the jittered camera rays."""
    spp, size = 4, 12
    scene, cam = glass_scene(size, spp, device="cpu")
    jitter = np.random.default_rng(12).random((spp, cam.num_pixels, 2), dtype=np.float32)
    jitter[0] = 0.0  # sample 0 is the unjittered center ray
    px, py = cam.pixel_grid()
    cfg = RenderConfig(use_pallas=True)
    ours = wt.wavefront_spp_trace_plain(
        pack_scene_tables(flatten_scene(scene)), cam, px, py, cfg, jitter=torch.from_numpy(jitter)
    ).numpy()

    j_scene, j_cam = glass_scene(size, spp, pkg=jax_builders)
    jpx, jpy = j_cam.pixel_grid()
    rays = [j_cam.rays_for_pixels(jpx, jpy, jnp.asarray(j)) for j in jitter]
    o, d = (jnp.concatenate(x) for x in zip(*rays))  # one call for all samples
    img = jit_o0(lambda s, o, d: jax_integrate_wavefront(jax_flatten(s), o, d, JaxConfig()))(j_scene, o, d)
    ref = np.asarray(img).reshape(spp, -1, 3).mean(axis=0)
    report = seam_budget(ours, ref)
    print(f"spp={spp}: {report}")
    assert np.isfinite(ours).all() and report.ok, report


@pytest.mark.parametrize("scene_name, spp", [
    pytest.param("sphere", 1, id="1"), pytest.param("sphere", 3, id="3"),
    pytest.param("mesh", 1, id="mesh-1"), pytest.param("mesh", 3, id="mesh-3")])
def test_glass_render_routes_through_wavefront_wrappers(monkeypatch, scene_name, spp):
    """use_pallas=True on a CPU glass scene goes through
    wavefront_trace_fused (spp=1; wavefront_trace without gradients) or
    wavefront_spp_trace (spp > 1) to their plain versions, no launch
    counted, and equals the integrator: render_hdr with use_pallas=False at
    spp=1, the same AA loop over integrate_wavefront at spp > 1. The
    wrappers get culled tables, packed once per frame, above TRI_BLOCK
    triangles (the glass mesh) and linear ones below. On the glass mesh a
    training step's forward (wavefront_trace, the counting kernel on the
    card) takes the culled tables and the adjoint (wavefront_grad) the
    linear ones."""
    calls = {"trace": [], "spp": []}  # each call's tables: culled or not
    for name, key in (("wavefront_trace_fused", "trace"), ("wavefront_spp_trace", "spp")):
        orig = getattr(pipeline, name)

        def spy(tables, *a, _orig=orig, _key=key, **k):
            calls[_key].append(tables.culled)
            return _orig(tables, *a, **k)

        monkeypatch.setattr(pipeline, name, spy)
    packs = []
    pack = pipeline.pack_forward_tables_perm
    monkeypatch.setattr(pipeline, "pack_forward_tables_perm",
                        lambda *a: packs.append(a[1:]) or pack(*a))
    launches = (wt.wavefront_trace.launches, wt.wavefront_spp_trace.launches)
    scene, cam = GLASS_SCENES[scene_name](8, spp, device="cpu")
    cfg = RenderConfig(use_pallas=True, chunk_size=40)
    img = pipeline.render_hdr(scene, cam, cfg, seed=5)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert (wt.wavefront_trace.launches, wt.wavefront_spp_trace.launches) == launches
    n_chunks = 2  # 64 pixels in chunks of 40
    culled = scene_name == "mesh"
    assert packs == ([(None,)] if culled else [])  # once per frame, in no particular order
    want = [culled] * n_chunks
    assert calls == ({"trace": want, "spp": []} if spp == 1 else {"trace": [], "spp": want})
    cfg_xla = dataclasses.replace(cfg, use_pallas=False)
    if spp == 1:
        ref = pipeline.render_hdr(scene, cam, cfg_xla)
    else:
        flat = flatten_scene(scene)
        ref = mean_over_samples(
            lambda o, d: integrate_wavefront(flat, o, d, cfg_xla), cam, *cam.pixel_grid(), seed=5,
        ).reshape(8, 8, 3)
    report = seam_budget(img.numpy(), ref.numpy())
    assert report.ok, report
    if not (culled and spp == 1):
        return
    seen = {}
    for name in ("wavefront_trace", "wavefront_grad"):
        orig = getattr(wg, name)

        def spy(tables, *a, _orig=orig, _name=name, **k):
            seen[_name] = tables.culled
            return _orig(tables, *a, **k)

        monkeypatch.setattr(wg, name, spy)
    params, static = partition(scene)
    _, cam4 = GLASS_SCENES[scene_name](4, device="cpu")
    small = dataclasses.replace(cfg, max_depth=3, wavefront_budget=12)
    pipeline.render_hdr(combine(params, static), cam4, small).sum().backward()
    assert seen == {"wavefront_trace": True, "wavefront_grad": False}
    assert float(params["triangles.materials.transparency"].grad.abs().sum()) > 0


def test_head_box_default_config_matches_jax():
    """RenderConfig() (march shadows, no kernels) on the opaque head box:
    the chain integrator with the march, against the JAX render."""
    scene, cam = builders.head_box_scene(width=12, height=12, spp=1, device="cpu")
    ours = pipeline.render_hdr(scene, cam, RenderConfig()).numpy()
    j_scene, j_cam = jax_builders.head_box_scene(width=12, height=12, spp=1)
    ref = np.asarray(jit_o0(lambda s, c: jax_render_hdr(s, c, JaxConfig()))(j_scene, j_cam))
    report = seam_budget(ours, ref)
    print(report)
    assert np.isfinite(ours).all() and report.ok, report


def test_glass_grads_flow_through_kernel_route():
    """With use_pallas=True a glass scene's gradients run through the
    wavefront kernel route (WavefrontTraceFused, whose backward on a CPU
    tensor is wavefront_grad_plain) and equal autograd of the fixed-trip
    integrate_wavefront (use_pallas=False, differentiable=True) under the
    leaf budget; the forward-only wrappers still refuse grad."""
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, max_depth=3, wavefront_budget=16)
    scene, cam = glass_scene(8, device="cpu")
    grads = {}
    for route, c in (("kernel", cfg), ("integrator", dataclasses.replace(cfg, use_pallas=False, differentiable=True))):
        params, static = partition(scene)
        img = pipeline.render_hdr(combine(params, static), cam, c)
        img.sum().backward()
        grads[route] = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                        for k, p in params.items()}
    errors = grad_leaf_mismatches(grads["kernel"], grads["integrator"])
    assert not errors, errors
    assert abs(grads["kernel"]["spheres.materials.transparency"][0]) > 0
    params, static = partition(scene)
    tables = pack_scene_tables(flatten_scene(combine(params, static)))
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    with pytest.raises(NotImplementedError, match="forward-only"):
        wt.wavefront_trace(tables, o.contiguous(), d.contiguous(), cfg)
    _, cam3 = glass_scene(8, 3, device="cpu")
    px, py = cam3.pixel_grid()
    with pytest.raises(NotImplementedError, match="forward-only"):
        wt.wavefront_spp_trace(tables, cam3, px, py, cfg)
    with torch.no_grad():  # forward-only renders still run
        assert torch.isfinite(pipeline.render_hdr(combine(params, static), cam, cfg)).all()


def test_integrate_wavefront_grads_match_jax():
    """Autograd of integrate_wavefront (fixed-trip, budget 64, binary
    shadows, 8x8) against jax.grad for every float scene leaf, sum(img^2):
    the reference the glass adjoint will be held to."""
    cfg_kw = dict(shadow_mode="binary", differentiable=True, wavefront_budget=64)
    j_scene, j_cam = glass_scene(8, pkg=jax_builders)
    o, d = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    @jit_o0
    def img_and_grad(s):
        img, vjp = jax.vjp(lambda s: jax_integrate_wavefront(jax_flatten(s), o, d, JaxConfig(**cfg_kw)), s)
        return img, vjp(2.0 * img)[0]

    img_ref, g_scene = img_and_grad(j_scene)
    ref = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}

    scene, _ = glass_scene(8, device="cpu")
    params, static = partition(scene)
    img = integrate_wavefront(
        flatten_scene(combine(params, static)), torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(d)), RenderConfig(**cfg_kw),
    )
    loss = (img * img).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float((np.asarray(img_ref, np.float64) ** 2).sum()), rtol=1e-5)
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors
    glass = ours["spheres.materials.transparency"][0], ours["spheres.materials.refractive_index"][0]
    assert all(abs(g) > 0 for g in glass)  # the glass sphere's refraction is differentiated


# ---------------------------------------------------------------------------
# Trees deeper than the CUDA kernels' stack
# ---------------------------------------------------------------------------


def test_glass_past_kernel_stack_renders_and_matches_jax():
    """max_depth 31 needs a stack of 33 nodes, past the kernels' MAX_CAP:
    render_hdr with use_pallas=True routes the glass scene to
    integrate_wavefront (as the JAX package routes past its ceilings) and
    matches the JAX render_hdr under the seam budget."""
    cfg = RenderConfig(max_depth=31, use_pallas=True)
    assert cfg.max_depth + 2 > wt.MAX_CAP
    scene, cam = glass_scene(8, device="cpu")
    ours = pipeline.render_hdr(scene, cam, cfg).numpy()
    j_scene, j_cam = glass_scene(8, pkg=jax_builders)
    ref = np.asarray(jit_o0(lambda s, c: jax_render_hdr(s, c, JaxConfig(max_depth=31)))(j_scene, j_cam))
    report = seam_budget(ours, ref)
    print(report)
    assert np.isfinite(ours).all() and report.ok, report


def test_kernel_stack_ceiling_routes_and_refuses():
    """pallas_applicable sends a tree past MAX_CAP to the integrator; the
    wrappers' check refuses it on a CUDA device and lets the plain
    versions (CPU) take it."""
    from raytracingengine_tpu_torch.kernels.chain_trace import pallas_applicable

    deep, ok = RenderConfig(max_depth=wt.MAX_CAP - 1), RenderConfig(max_depth=wt.MAX_CAP - 2)
    assert not pallas_applicable(deep, "wavefront") and pallas_applicable(ok, "wavefront")
    wt._check_cfg(deep, torch.device("cpu"))
    wt._check_cfg(ok, torch.device("cuda"))
    with pytest.raises(ValueError, match="max_depth"):
        wt._check_cfg(deep, torch.device("cuda"))
    with pytest.raises(ValueError, match="max_depth"):
        wt._check_cfg(RenderConfig(max_depth=-1), torch.device("cpu"))
