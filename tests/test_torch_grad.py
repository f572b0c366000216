"""PyTorch port, training path: the differentiable integrator and the chain
adjoint against jax.grad of the JAX package's integrate_chain.

The JAX reference is XLA autodiff of integrate_chain, the function the JAX
package's own tests/test_chain_grad.py holds its fused adjoint to. Budgets
(raytracingengine_tpu_torch/parity.py): loss rtol 1e-5; each scene leaf
rtol 2e-3 and atol 2e-4 + 1e-3 * max|g_ref| (fp32 sums over rays in other
orders); ray origins atol 1e-4 * max|g_ref|; ray directions on their
tangential part. The head box camera is nudged off-axis, as in
tests/test_chain_grad.py: centred pixel rays fall exactly on the cube's
triangle edges, where two implementations pick different valid
subgradients.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.core import vecmath as jax_vm
from raytracingengine_tpu.geometry import intersect as jax_isect
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_chain as jax_integrate_chain
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry import intersect as isect
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.kernels.chain_grad import MAX_PRIMS, chain_trace_fused
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.parity import (
    direction_cot_ok,
    grad_leaf_mismatches,
    origin_cot_ok,
    seam_budget,
)
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scene import SceneBuilder
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

#: name -> (builder, kwargs, image side, max_depth, camera nudge)
SCENES = {
    "baseline_spheres": ("baseline_sphere_scene", dict(n_lights=2), 16, 4, None),
    "head_box_nudged": ("head_box_scene", {}, 12, 3, (0.013, 0.007, 0.0)),
}


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def jax_scene(name):
    fn, kw, size, depth, nudge = SCENES[name]
    scene, cam = getattr(jax_builders, fn)(width=size, height=size, spp=1, **kw)
    if nudge is not None:
        cam = dataclasses.replace(cam, position=cam.position + jnp.asarray(nudge))
    return scene, cam, JaxConfig(shadow_mode="binary", max_depth=depth)


def jax_rays(name):
    scene, cam, cfg = jax_scene(name)
    return scene, *cam.rays_for_pixels(*cam.pixel_grid()), cfg


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """-> (rays o, d, image, scene-leaf grads, d_o, d_d) of sum(img^2)."""
    scene, o, d, cfg = jax_rays(name)

    @jit_o0
    def img_and_grads(s, oo, dd):  # one compile for the forward and the VJP
        img, vjp = jax.vjp(lambda s, oo, dd: integrate_chain_jax(s, oo, dd, cfg), s, oo, dd)
        return img, vjp(2.0 * img)

    img, (g_scene, g_o, g_d) = img_and_grads(scene, o, d)
    grads = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}
    return np.array(o), np.array(d), np.asarray(img), grads, np.asarray(g_o), np.asarray(g_d)


def integrate_chain_jax(scene, o, d, cfg):
    return jax_integrate_chain(jax_isect.flatten_scene(scene), o, d, cfg)


def port_setup(name):
    fn, kw, size, depth, _ = SCENES[name]
    scene, _ = getattr(builders, fn)(width=size, height=size, spp=1, device="cpu", **kw)
    o, d = (np.array(x) for x in jax_rays(name)[1:3])
    cfg = RenderConfig(shadow_mode="binary", max_depth=depth, use_pallas=True)
    return scene, torch.from_numpy(o), torch.from_numpy(d), cfg


PATHS = {
    "integrate_chain": lambda flat, o, d, cfg: integrate_chain(flat, o, d, cfg),
    "chain_trace_fused": lambda flat, o, d, cfg: chain_trace_fused(pack_scene_tables(flat), o, d, cfg),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_integrate_chain_forward_matches_jax(name):
    scene, o, d, cfg = port_setup(name)
    ours = integrate_chain(isect.flatten_scene(scene), o, d, cfg).numpy()
    report = seam_budget(ours, jax_reference(name)[2])
    print(f"{name}: {report}")
    assert np.isfinite(ours).all() and report.ok, report


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_grads_match_jax(name, path):
    """Every float scene leaf, transparency included: the bounce multiplies
    by 1 - clip(tau, 0, 1) at tau = 0, where JAX's subgradient is 0.5."""
    scene, o, d, cfg = port_setup(name)
    _, _, img_ref, ref, _, _ = jax_reference(name)
    params, static = partition(scene)
    img = PATHS[path](isect.flatten_scene(combine(params, static)), o, d, cfg)
    loss = (img * img).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float((img_ref.astype(np.float64) ** 2).sum()), rtol=1e-5)
    # a leaf the path never reads (the kernel reads no refractive index)
    # gets no .grad; JAX's gradient there is zeros
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors
    if name.startswith("head_box"):
        tau = ours["triangles.materials.transparency"]
        assert np.abs(tau).max() > 0.0  # the (1 - tau) factor is differentiated


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fused_ray_grads_match_jax(name):
    scene, o, d, cfg = port_setup(name)
    _, _, _, _, go_ref, gd_ref = jax_reference(name)
    o, d = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    tables = pack_scene_tables(isect.flatten_scene(scene))
    img = chain_trace_fused(tables, o, d, cfg)
    (img * img).sum().backward()
    ok, err, bound = origin_cot_ok(o.grad.numpy(), go_ref)
    assert ok, (err, bound)
    ok, p99, mx, scale = direction_cot_ok(d.grad.numpy(), gd_ref, d.detach().numpy())
    print(f"{name}: d cotangent tangential p99 {p99:.3e} max {mx:.3e} scale {scale:.3e}")
    assert ok, (p99, mx, scale)


def seeded_rays(n=256, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("fn", ["head_box_scene", "baseline_sphere_scene"])
def test_closest_hit_and_any_hit_match_jax(fn):
    o, d = seeded_rays()
    j_scene, _ = getattr(jax_builders, fn)(width=8, height=8, spp=1)
    j_flat = jax_isect.flatten_scene(j_scene)
    scene, _ = getattr(builders, fn)(width=8, height=8, spp=1, device="cpu")
    flat = isect.flatten_scene(scene)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ref = jax.jit(jax_isect.closest_hit)(j_flat, jnp.asarray(o), jnp.asarray(d))
    ours = isect.closest_hit(flat, to, td)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), valid)
    assert valid.sum() > 64
    np.testing.assert_array_equal(ours.family.numpy(), np.asarray(ref.family))
    for field in ("t", "point", "normal", "albedo", "specular", "shininess"):
        np.testing.assert_allclose(
            getattr(ours, field).numpy()[valid], np.asarray(getattr(ref, field))[valid],
            rtol=1e-5, atol=2e-5, err_msg=field,
        )
    max_dist = np.random.default_rng(6).uniform(0.5, 30.0, o.shape[0]).astype(np.float32)
    occ = isect.any_hit_before(flat, to, td, torch.from_numpy(max_dist)).numpy()
    occ_ref = np.asarray(
        jax.jit(jax_isect.any_hit_before)(j_flat, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_dist)))
    np.testing.assert_array_equal(occ, occ_ref)
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("fn", ["sqrt_grad_safe", "refract", "lerp", "clamp01"])
def test_vecmath_values_and_grads_match_jax(fn):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    x = np.abs(a[:, 0])
    x[:2] = 0.0  # sqrt's clamped derivative at 0
    eta = rng.uniform(0.5, 1.6, 64).astype(np.float32)
    t = rng.uniform(-0.5, 1.5, (64, 1)).astype(np.float32)
    a[:4, 0] = [0.0, 1.0, 0.0, 1.0]  # clip ties: subgradient 0.5
    args = {
        "sqrt_grad_safe": (x,), "refract": (a, b, eta), "lerp": (a, b, t), "clamp01": (a,),
    }[fn]
    ref_val = np.asarray(getattr(jax_vm, fn)(*args))
    ref_grads = jax.grad(lambda *xs: jnp.sum(getattr(jax_vm, fn)(*xs) ** 2), argnums=tuple(range(len(args))))(*args)
    ts = [torch.from_numpy(v).requires_grad_(True) for v in args]
    out = getattr(vm, fn)(*ts)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_val, rtol=1e-5, atol=1e-6)
    for tt, g in zip(ts, ref_grads):
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5)


def test_focal_grad_through_render_hdr_matches_jax():
    """d mean(img^2) / d focal through render_hdr: the port with the kernel
    route (plain adjoint on the CPU) against the JAX XLA path, rtol 5e-3."""
    j_scene, j_cam = jax_builders.baseline_sphere_scene(width=16, height=16, spp=1)
    jcfg = JaxConfig(shadow_mode="binary", chunk_size=256)

    def jloss(focal):
        return jnp.mean(jax_render_hdr(j_scene, dataclasses.replace(j_cam, focal=focal), jcfg) ** 2)

    g_ref = float(jit_o0(jax.grad(jloss))(j_cam.focal))
    scene, cam = builders.baseline_sphere_scene(width=16, height=16, spp=1, device="cpu")
    focal = cam.focal.clone().requires_grad_(True)
    cfg = RenderConfig(shadow_mode="binary", chunk_size=100, use_pallas=True)
    img = render_hdr(scene, dataclasses.replace(cam, focal=focal), cfg)
    (img * img).mean().backward()
    assert abs(g_ref) > 0
    np.testing.assert_allclose(float(focal.grad), g_ref, rtol=5e-3)


def test_spp_with_grad_raises():
    """spp > 1 with gradients through the in-kernel AA raises ValueError
    (it has no backward) and asks for differentiable=True, which trains
    through the per-sample loop; forward-only spp > 1 takes the AA."""
    scene, cam = builders.head_box_scene(width=8, height=8, spp=2, device="cpu")
    params, static = partition(scene)
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True)
    with pytest.raises(ValueError, match="differentiable=True"):
        render_hdr(combine(params, static), cam, cfg)
    with torch.no_grad():  # forward-only spp > 1 still renders
        assert torch.isfinite(render_hdr(combine(params, static), cam, cfg)).all()
    img = render_hdr(combine(params, static), cam, dataclasses.replace(cfg, differentiable=True))
    (img * img).mean().backward()
    assert float(params["triangles.v0"].grad.abs().max()) > 0


def test_grad_above_adjoint_scope_raises(monkeypatch):
    """Past chain_grad's 512 primitives a scene no longer raises: its 513
    triangles take culled tables, the backward routes to the dense adjoint
    (chain_grad_dense; its plain version on the CPU), and the leaf
    gradients match autograd of the port's integrate_chain. chain_grad
    itself still refuses such tables."""
    import raytracingengine_tpu_torch.kernels.chain_grad as cg

    b = SceneBuilder()
    mat = Material(color=(0.5, 0.5, 0.5))
    for i in range(MAX_PRIMS + 1):
        x = float(i % 32) - 16.0
        y = float(i // 32) - 8.0
        b.add_triangle((x, y, 5.0), (x + 0.9, y, 5.0), (x, y + 0.9, 5.0), mat)
    b.add_light((0.0, 0.0, -5.0), (1.0, 1.0, 1.0), 50.0)
    scene = b.build(device="cpu")
    _, cam = builders.baseline_sphere_scene(width=4, height=4, spp=1, device="cpu")
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, max_depth=2)
    calls = []
    dense = cg.chain_grad_dense_plain
    monkeypatch.setattr(cg, "chain_grad_dense_plain", lambda *a: calls.append(a[0]) or dense(*a))
    grads = {}
    for use_pallas in (True, False):
        params, static = partition(scene)
        img = render_hdr(combine(params, static), cam, dataclasses.replace(cfg, use_pallas=use_pallas))
        (img * img).mean().backward()
        grads[use_pallas] = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                             for k, p in params.items()}
    assert len(calls) == 1 and calls[0].culled
    assert np.abs(grads[True]["triangles.v0"]).max() > 0
    errors = grad_leaf_mismatches(grads[True], grads[False])
    assert not errors, errors
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    with pytest.raises(NotImplementedError, match="use chain_grad_dense"):
        cg.chain_grad(calls[0], o.contiguous(), d, torch.zeros_like(o), cfg)
