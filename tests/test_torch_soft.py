"""PyTorch port, the soft paths against the JAX package on the CPU:
render/shading.py::visibility_soft (shadow_mode="soft") and
render/soft_primary.py (soft_primary=True).

(b) visibility_soft's values and its gradients in the sphere centres,
radii and transparencies and in the rays, against jax.vjp of the JAX
function on the same seeded rays: values atol 1e-5; gradients
parity.grad_leaf_mismatches (rtol 2e-3, atol 2e-4 + 1e-3 * max|ref|).
(c) render_hdr with soft shadows and with soft_primary at spp=1 against
jax.vjp of the JAX render_hdr (its integrators): the frame under the seam
budget (HDR atol 1e-4 except max(4, 1e-3 * pixels) seam-tie pixels), every
float scene leaf and the camera focal within grad_leaf_mismatches. Neither
path has a kernel; the port takes them with use_pallas=True too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.render.shading import visibility_soft as jax_visibility_soft
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.parity import grad_leaf_mismatches, seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr, render_rays
from raytracingengine_tpu_torch.render.shading import visibility_soft
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

FLAT_LEAVES = ("sph_centers", "sph_radii", "transparency")


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def shadow_rays(n=256, seed=3):
    """Shadow rays toward the baseline scene's first light, from just above
    its floor, from below it (the floor blocks them) and from points around
    its spheres: origins, unit directions, the distance to the light."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2.5, 2.0, n), rng.uniform(2, 12, n)], 1)
    o[: n // 2, 1] = -2.49  # just above the floor
    o[n // 2: 5 * n // 8, 1] = -3.0  # below it
    light = np.array([0.0, 6.0, -2.0])
    v = light - o
    dist = np.linalg.norm(v, axis=1)
    return o.astype(np.float32), (v / dist[:, None]).astype(np.float32), (dist - 1e-3).astype(np.float32)


def test_visibility_soft_matches_jax():
    """(b) On baseline spheres with a floor (the hard plane crossing), the
    spheres' transparencies 0, 0.3 and 1 (clip's ties), sigma 0.1 and 0.5."""
    o, d, md = shadow_rays()
    w = np.random.default_rng(4).normal(size=o.shape[0]).astype(np.float32)
    j_scene, _ = jax_builders.baseline_sphere_scene(width=8, height=8)
    scene, _ = builders.baseline_sphere_scene(8, 8, device="cpu")
    tau = np.array([0.0, 0.3, 1.0], np.float32)
    for sigma in (0.1, 0.5):
        j_flat = dataclasses.replace(jax_flatten(j_scene), transparency=jnp.asarray(
            np.concatenate([tau, np.asarray(jax_flatten(j_scene).transparency)[3:]])))

        def vis(leaves, oo, dd):
            fl = dataclasses.replace(j_flat, **leaves)
            return jax_visibility_soft(fl, oo, dd, jnp.asarray(md), JaxConfig(soft_sigma=sigma))

        leaves = {k: getattr(j_flat, k) for k in FLAT_LEAVES}
        ref, vjp = jax.vjp(vis, leaves, jnp.asarray(o), jnp.asarray(d))
        ref_leaves, ref_o, ref_d = vjp(jnp.asarray(w))

        flat = flatten_scene(scene)
        ours = {k: getattr(flat, k).clone().requires_grad_(True) for k in FLAT_LEAVES}
        with torch.no_grad():
            ours["transparency"][:3] = torch.from_numpy(tau)
        to, td = torch.from_numpy(o).requires_grad_(True), torch.from_numpy(d).requires_grad_(True)
        v = visibility_soft(dataclasses.replace(flat, **ours), to, td, torch.from_numpy(md),
                            RenderConfig(soft_sigma=sigma))
        (v * torch.from_numpy(w)).sum().backward()
        ref = np.asarray(ref)
        np.testing.assert_allclose(v.detach().numpy(), ref, rtol=0, atol=1e-5)
        assert (ref == 0).sum() > 8 and (ref > 0.999).sum() > 8 and ((ref > 0.01) & (ref < 0.99)).sum() > 8
        errors = grad_leaf_mismatches(
            {**{k: t.grad.numpy() for k, t in ours.items()}, "o": to.grad.numpy(), "d": td.grad.numpy()},
            {**{k: np.asarray(ref_leaves[k]) for k in FLAT_LEAVES}, "o": np.asarray(ref_o),
             "d": np.asarray(ref_d)})
        assert not errors, (sigma, errors)
        assert np.abs(ours["sph_centers"].grad.numpy()).max() > 1e-2


def test_soft_renders_match_jax():
    """(c) Baseline spheres 12x12 spp=1, 2 lights: shadow_mode="soft"
    (sigma 0.3) and soft_primary=True (sigma 0.1, binary shadows), frame and
    gradients; render_rays routes soft_primary in chain mode the same way,
    and wavefront mode ignores it."""
    size = 12
    for name, kw in (("soft shadows", dict(shadow_mode="soft", soft_sigma=0.3)),
                     ("soft primary", dict(shadow_mode="binary", soft_sigma=0.1, soft_primary=True))):
        j_scene, j_cam = jax_builders.baseline_sphere_scene(width=size, height=size, spp=1, n_lights=2)
        jcfg = JaxConfig(max_depth=4, chunk_size=size * size, **kw)

        @jit_o0
        def img_and_grads(s, focal):
            img, vjp = jax.vjp(lambda s, f: jax_render_hdr(s, dataclasses.replace(j_cam, focal=f), jcfg),
                               s, focal)
            return img, vjp(2.0 * img / img.size)

        ref_img, (g_scene, g_focal) = img_and_grads(j_scene, j_cam.focal)
        ref = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}
        ref["camera.focal"] = np.asarray(g_focal)

        scene, cam = builders.baseline_sphere_scene(size, size, spp=1, n_lights=2, device="cpu")
        cfg = RenderConfig(max_depth=4, chunk_size=50, use_pallas=True, **kw)
        params, static = partition(scene)
        focal = cam.focal.clone().requires_grad_(True)
        img = render_hdr(combine(params, static), dataclasses.replace(cam, focal=focal), cfg)
        (img * img).mean().backward()
        report = seam_budget(img.detach().numpy(), np.asarray(ref_img))
        print(f"{name}: {report}")
        assert report.ok, (name, report)
        ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                for k, p in params.items()}
        ours["camera.focal"] = focal.grad.numpy()
        errors = grad_leaf_mismatches(ours, ref)
        assert not errors, (name, errors)
        assert np.abs(ours["spheres.centers"]).max() > 1e-3

        with torch.no_grad():
            rays = cam.rays_for_pixels(*cam.pixel_grid())
            torch.testing.assert_close(render_rays(scene, *rays, cfg), img.detach().reshape(-1, 3),
                                       rtol=0, atol=0)
    glass, g_cam = builders.glass_sphere_scene(8, 8, device="cpu")
    g_cfg = RenderConfig(max_depth=4, wavefront_budget=40, use_pallas=True)
    with torch.no_grad():
        torch.testing.assert_close(render_hdr(glass, g_cam, dataclasses.replace(g_cfg, soft_primary=True)),
                                   render_hdr(glass, g_cam, g_cfg), rtol=0, atol=0)
