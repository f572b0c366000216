"""PyTorch port, the per-sample differentiable loop of render_hdr at spp > 1
(render/pipeline.py), against the JAX package on the CPU.

The reference is the JAX package's `_render_chunk` loop written out: for
each sample the camera rays Camera.rays_for_pixels(px, py, jitter) with the
port's own jitter (`pixel_jitter`, as numpy), traced by the XLA
integrate_chain / integrate_wavefront (differentiable=True) and averaged;
the loss mean(img^2), differentiated by jax.vjp in every scene leaf and the
camera's position and focal. The port runs render_hdr with
`use_pallas=True, differentiable=True` (chain_trace_fused and
wavefront_trace_fused: their plain versions and plain adjoints on the CPU)
and with `use_pallas=False` (the integrators under autograd; without
`differentiable`, whose fixed trips give the same values and gradients in
PyTorch and take minutes here).

Budgets: the frame under the seam budget (elementwise HDR atol 1e-4 except
max(4, 1e-3 * pixels) seam-tie pixels); every scene and camera leaf
parity.grad_leaf_mismatches (rtol 2e-3, atol 2e-4 + 1e-3 * max|ref leaf|:
fp32 sums over rays in other orders). The loop against the in-kernel AA's
plain version at the same seed: the seam budget at atol 1e-5 (the AA
builds its rays with rsqrt, the camera divides by a square root). A dense
mesh (culled tables) through the kernels against the port's integrators:
grad_leaf_mismatches, and one packing per chunk.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_chain as jax_integrate_chain
from raytracingengine_tpu.render.integrator import integrate_wavefront as jax_integrate_wavefront
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.kernels import spp_trace as st
from raytracingengine_tpu_torch.kernels import wavefront_trace as wt
from raytracingengine_tpu_torch.parity import grad_leaf_mismatches, seam_budget
from raytracingengine_tpu_torch.render import pipeline
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

SIZE, SPP, SEED = 12, 3, 1234
#: name -> (builder, config fields, JAX integrator, camera nudge). The head
#: box camera is nudged off-axis as in tests/test_torch_grad.py: its centre
#: rays fall exactly on the cube's triangle edges.
SCENES = {
    "head_box": ("head_box_scene", dict(shadow_mode="binary", max_depth=3), jax_integrate_chain,
                 (0.013, 0.007, 0.0)),
    "glass": ("glass_sphere_scene", dict(shadow_mode="march", max_depth=4, wavefront_budget=40),
              jax_integrate_wavefront, None),
}


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def jitter_np(n_pixels: int) -> np.ndarray:
    """[SPP, R, 2]: the port's Philox jitter of the row-major pixels."""
    pids = torch.arange(n_pixels, dtype=torch.int32)
    return np.stack([st.pixel_jitter(SEED, pids, s).numpy() for s in range(SPP)])


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """-> (frame [H,W,3], float scene-leaf grads, camera grads) of
    mean(img^2), every sample's rays traced in one batch."""
    fn, cfg_kw, integrate, nudge = SCENES[name]
    scene, cam = getattr(jax_builders, fn)(width=SIZE, height=SIZE, spp=SPP)
    if nudge is not None:
        cam = dataclasses.replace(cam, position=cam.position + jnp.asarray(nudge))
    cfg = JaxConfig(differentiable=True, **cfg_kw)
    px, py = cam.pixel_grid()
    jitter = jnp.asarray(jitter_np(cam.num_pixels))

    def frame(s, c):
        rays = [c.rays_for_pixels(px, py, jitter[k]) for k in range(SPP)]
        o = jnp.concatenate([r[0] for r in rays])
        d = jnp.concatenate([r[1] for r in rays])
        img = integrate(jax_flatten(s), o, d, cfg).reshape(SPP, -1, 3).sum(0) / SPP
        return img.reshape(SIZE, SIZE, 3)

    @jit_o0
    def img_and_grads(s, c):
        img, vjp = jax.vjp(frame, s, c)
        return img, vjp(2.0 * img / img.size)

    img, (g_scene, g_cam) = img_and_grads(scene, cam)
    grads = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}
    return np.asarray(img), grads, {k: np.asarray(getattr(g_cam, k)) for k in ("position", "focal")}


def port_scene(name):
    fn, cfg_kw, _, nudge = SCENES[name]
    scene, cam = getattr(builders, fn)(width=SIZE, height=SIZE, spp=SPP, device="cpu")
    if nudge is not None:
        cam = dataclasses.replace(cam, position=cam.position + torch.tensor(nudge))
    return scene, cam, cfg_kw


def test_sample_loop_matches_jax(monkeypatch):
    """(a) Head box and glass at 12x12 spp=3, through the kernels' autograd
    Functions and through the integrators, in chunks of 5 rows (the chain
    adjoint's pixel-tile map) and of 50 pixels (not whole rows); then a
    dense mesh's culled tables."""
    for name in SCENES:
        ref_img, ref_grads, ref_cam = jax_reference(name)
        for use_pallas, chunk in ((True, 5 * SIZE), (False, 5 * SIZE), (True, 50)):
            scene, cam, cfg_kw = port_scene(name)
            cfg = RenderConfig(use_pallas=use_pallas, differentiable=use_pallas, chunk_size=chunk,
                               **cfg_kw)
            params, static = partition(scene)
            position = cam.position.clone().requires_grad_(True)
            focal = cam.focal.clone().requires_grad_(True)
            cam = dataclasses.replace(cam, position=position, focal=focal)
            img = render_hdr(combine(params, static), cam, cfg, seed=SEED)
            (img * img).mean().backward()
            label = f"{name} use_pallas={use_pallas} chunk={chunk}"
            report = seam_budget(img.detach().numpy(), ref_img)
            print(f"{label}: {report}")
            assert report.ok, (label, report)
            ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                    for k, p in params.items()}
            errors = grad_leaf_mismatches(ours, ref_grads)
            errors += grad_leaf_mismatches({"camera.position": position.grad.numpy(),
                                            "camera.focal": focal.grad.numpy()},
                                           {f"camera.{k}": v for k, v in ref_cam.items()})
            assert not errors, (label, errors)
            assert abs(float(focal.grad)) > 0 and np.abs(ours["planes.materials.color"]).max() > 0

        # The loop and the in-kernel AA's plain version draw the same jitter.
        scene, cam, cfg_kw = port_scene(name)
        cfg = RenderConfig(use_pallas=True, differentiable=True, **cfg_kw)
        aa_plain = wt.wavefront_spp_trace_plain if name == "glass" else st.spp_trace_plain
        with torch.no_grad():
            loop = render_hdr(scene, cam, cfg, seed=SEED)
            aa = aa_plain(pack_scene_tables(flatten_scene(scene)), cam, *cam.pixel_grid(), cfg, seed=SEED)
        report = seam_budget(loop.reshape(-1, 3).numpy(), aa.numpy(), atol=1e-5)
        print(f"{name}: the loop vs {aa_plain.__name__}, seed {SEED}: {report}")
        assert report.ok, report

        # With gradients, the in-kernel AA has no backward: it asks for
        # differentiable=True.
        params, static = partition(scene)
        with pytest.raises(ValueError, match="differentiable=True"):
            render_hdr(combine(params, static), cam, dataclasses.replace(cfg, differentiable=False))

    # Culled tables (a dense mesh above 128 triangles) at spp=3: packed once
    # per chunk for every sample; the kernels' gradients (the culled
    # forward and chain_grad_dense, plain on the CPU) match the
    # integrators' (use_pallas=False) leaf by leaf.
    packs = []
    pack = pipeline.pack_forward_tables_perm
    monkeypatch.setattr(pipeline, "pack_forward_tables_perm", lambda *a: packs.append(1) or pack(*a))
    scene, cam = builders.dense_mesh_scene(8, 8, spp=SPP, ni=8, nj=12, device="cpu")
    grads = {}
    for use_pallas in (True, False):
        cfg = RenderConfig(shadow_mode="binary", use_pallas=use_pallas, differentiable=use_pallas,
                           max_depth=3, chunk_size=40)
        params, static = partition(scene)
        img = render_hdr(combine(params, static), cam, cfg, seed=SEED)
        (img * img).mean().backward()
        grads[use_pallas] = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
                             for k, p in params.items()}
    assert len(packs) == 2  # two chunks of 40 and 24 pixels, three samples each
    errors = grad_leaf_mismatches(grads[True], grads[False])
    assert not errors, errors
    assert np.abs(grads[True]["triangles.v0"]).max() > 0
