"""PyTorch port, parallel/: sharded rendering and training over a world of
two CPU ranks (torch.distributed with gloo and a file:// rendezvous, the
ranks spawned), against the one-process paths, which the other port tests
hold to the JAX package. One test, every check inside it:

  * ray-sharded frames (render_hdr_sharded, and render_hdr(mesh=)) equal
    the one-process frames bit for bit: the head box at spp=1 and spp=3
    through the kernels' plain versions, the glass sphere at spp=2 (a
    pixel's jitter is keyed by its row-major id);
  * prim-sharded frames (two blocks of triangles, the hits combined by the
    all_gather argmin) within the seam budget of the one-process frames:
    a mesh scene (chain) and a glass scene with a transparent mesh
    (wavefront, march shadows); under use_pallas the prim axis warns and
    takes the integrators;
  * make_sharded_loss through the kernels' plain versions, and
    render_hdr(mesh=) under autograd: the loss and every parameter's
    gradient within rtol 1e-4 / atol 1e-6 of the one-process ones
    (tests/test_sharding.py's bar), on every rank.
"""

import dataclasses
import multiprocessing
import warnings

import numpy as np
import torch
import torch.distributed as dist

from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.kernels.chain_grad import chain_trace_fused
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.parallel import make_mesh, make_sharded_loss, render_hdr_sharded
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import PRIM_AXIS_WARNING, render_hdr
from raytracingengine_tpu_torch.scene import SceneBuilder
from raytracingengine_tpu_torch.scenes import assets, builders


def glass_mesh_scene(width, height):
    """The glass sphere scene with a transparent bumpy mesh beside it (176
    triangles)."""
    scene, cam = builders.glass_sphere_scene(width, height, device="cpu")
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 5.0), 1.5, Material(color=(1, 1, 1), transparency=0.9, refractive_index=1.5))
    b.add_sphere((1.5, -0.8, 9.0), 1.0, Material(color=(0.9, 0.4, 0.1)))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), Material(color=(0.8, 0.8, 0.8)))
    verts, idx = assets.bumpy_sphere_mesh(radius=1.0, ni=5, nj=22)
    b.add_model(verts, idx, Material(color=(0.6, 0.9, 0.7), transparency=0.7, refractive_index=1.3),
                translation=(-2.2, 0.6, 6.0))
    b.add_light((-3.0, 5.0, -1.0), (1, 1, 1), 60.0)
    return b.build(pad_multiple=2, device="cpu"), cam


def grads(params: dict) -> dict:
    """Each param's gradient, zeros where none reached it."""
    return {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}


def grads_off(a: dict, b: dict) -> list[str]:
    return [k for k in b if not np.allclose(a[k], b[k], rtol=1e-4, atol=1e-6)]


def _worker(rank: int, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2, rank=rank)
    try:
        rays, prims = make_mesh(), make_mesh(n_ray_shards=1, n_prim_shards=2)
        assert rays.shape == {"rays": 2, "prims": 1} and prims.shape == {"rays": 1, "prims": 2}
        kernels = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=40)

        # ray shards: bit for bit
        for (scene, cam), cfg in (
            (builders.head_box_scene(width=12, height=9, spp=1, device="cpu"), kernels),
            (builders.head_box_scene(width=12, height=9, spp=3, device="cpu"), kernels),
            (builders.glass_sphere_scene(9, 7, spp=2, device="cpu"),
             RenderConfig(use_pallas=True, max_depth=4, chunk_size=20)),
        ):
            one = render_hdr(scene, cam, cfg, seed=7)
            assert torch.equal(render_hdr_sharded(scene, cam, cfg, rays, seed=7), one)
            with torch.no_grad():
                assert torch.equal(render_hdr(scene, cam, cfg, seed=7, mesh=rays), one)

        # prim shards: the seam budget
        for (scene, cam), cfg in (
            (builders.dense_mesh_scene(10, 8, ni=4, nj=10, device="cpu"),
             RenderConfig(shadow_mode="binary", chunk_size=80)),
            (glass_mesh_scene(9, 7), RenderConfig(max_depth=4, chunk_size=63)),
        ):
            assert scene.triangles.v0.shape[0] % 2 == 0
            one = render_hdr(scene, cam, cfg).numpy()
            report = seam_budget(render_hdr_sharded(scene, cam, cfg, prims).numpy(), one)
            assert report.ok, report
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                img = render_hdr_sharded(scene, cam, dataclasses.replace(cfg, use_pallas=True), prims)
            assert any(str(w.message) == PRIM_AXIS_WARNING for w in caught)
            assert seam_budget(img.numpy(), one).ok

        # the sharded loss through the kernels, and render_hdr(mesh=) under autograd
        scene, cam = builders.baseline_sphere_scene(8, 4, spp=1, device="cpu")
        params, static = partition(scene)
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        target = torch.zeros_like(o)
        cfg = RenderConfig(shadow_mode="binary", use_pallas=True)
        loss = make_sharded_loss(static, cfg, rays)(params, o, d, target)
        loss.backward()
        params1, _ = partition(scene)
        img = chain_trace_fused(pack_scene_tables(flatten_scene(combine(params1, static))), o, d, cfg)
        loss1 = ((img - target) ** 2).mean()
        loss1.backward()
        assert np.isclose(float(loss), float(loss1), rtol=1e-4, atol=0.0), (float(loss), float(loss1))
        assert not grads_off(grads(params), grads(params1)), grads_off(grads(params), grads(params1))
        assert any(np.abs(g).max() > 0 for g in grads(params).values())
        for p in (*params.values(), *params1.values()):
            p.grad = None
        (render_hdr(combine(params, static), cam, cfg, mesh=rays) ** 2).sum().backward()
        (render_hdr(combine(params1, static), cam, cfg) ** 2).sum().backward()
        assert not grads_off(grads(params), grads(params1)), grads_off(grads(params), grads(params1))
    finally:
        dist.destroy_process_group()


def test_two_rank_world_matches_one_process(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, str(tmp_path / "rendezvous"))) for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not alive, f"ranks still running after 120 s: {alive}"
    assert [p.exitcode for p in procs] == [0, 0], [p.exitcode for p in procs]
