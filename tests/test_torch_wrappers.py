"""PyTorch port, kernel wrappers and routing.

(h) A CPU tensor reaches the plain version and leaves the launch counter
unchanged; unsupported configurations raise NotImplementedError; bad
inputs raise. The tests marked `gpu` need a CUDA card: they launch the
kernels against their plain versions (the adjoints and the wavefront
kernels on the glass sphere too) and check that a forward kernel's CUDA
input with requires_grad raises. They skip on a host without one.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import raytracingengine_tpu_torch.kernels.chain_grad as cg
import raytracingengine_tpu_torch.kernels.chain_trace as ct
import raytracingengine_tpu_torch.kernels.spp_trace as st
import raytracingengine_tpu_torch.kernels.wavefront_grad as wg
import raytracingengine_tpu_torch.kernels.wavefront_trace as wt
import raytracingengine_tpu_torch.render.pipeline as pipeline
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.parity import (
    TABLE_ROWS,
    ray_cot_seam_budget,
    seam_budget,
    table_cot_rows,
)
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)


def small_head_box(spp=1, device="cpu"):
    scene, cam = builders.head_box_scene(width=8, height=6, spp=spp, device=device)
    return scene, cam, ct.pack_scene_tables(flatten_scene(scene))


def grad_inputs(scene_name, width, height, device):
    """-> (tables, o, d, g) of an adjoint check: the head box, or baseline
    spheres with 2 lights (the head box has no spheres), and g = d mean(img^2)
    / d img."""
    if scene_name == "head_box":
        scene, cam = builders.head_box_scene(width=width, height=height, spp=1, device=device)
    else:
        scene, cam = builders.baseline_sphere_scene(width, height, n_lights=2, device=device)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    img = ct.chain_trace(tables, o, d, CFG)
    return tables, o, d, (2.0 * img / img.numel()).contiguous()


@pytest.mark.parametrize("spp", [1, 3])
def test_render_routes_cpu_to_plain_versions(monkeypatch, spp):
    calls = {"chain": 0, "spp": 0}
    orig_chain, orig_spp = ct.trace_chain_plain, st.spp_trace_plain

    def spy_chain(*a, **k):
        calls["chain"] += 1
        return orig_chain(*a, **k)

    def spy_spp(*a, **k):
        calls["spp"] += 1
        return orig_spp(*a, **k)

    monkeypatch.setattr(ct, "trace_chain_plain", spy_chain)
    monkeypatch.setattr(st, "spp_trace_plain", spy_spp)
    launches = (ct.chain_trace.launches, st.spp_trace.launches)
    scene, cam, _ = small_head_box(spp=spp)
    img = pipeline.render_hdr(scene, cam, dataclasses.replace(CFG, chunk_size=20))
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert (ct.chain_trace.launches, st.spp_trace.launches) == launches
    n_chunks = 3  # 48 pixels in chunks of 20
    assert calls == ({"chain": n_chunks, "spp": 0} if spp == 1 else {"chain": 0, "spp": n_chunks})


#: name -> (config overrides, spp). At spp=1 the wavefront mode, march
#: shadows, differentiable=True, use_pallas=False and the defaults all run
#: (kernels or integrators); at spp > 1 every path without an AA kernel
#: (chain mode with march shadows, use_pallas=False, the defaults) and every
#: differentiable one needs the per-sample loop, which is not ported.
UNSUPPORTED = {
    "wavefront": (dict(mode="wavefront", use_pallas=False), 3),
    "march": (dict(shadow_mode="march"), 3),
    "soft": (dict(shadow_mode="soft"), 1),
    "soft_primary": (dict(soft_primary=True), 1),
    "differentiable": (dict(differentiable=True), 3),
    "no_kernels": (dict(use_pallas=False), 3),
    "defaults": (None, 3),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_configs_raise(name):
    overrides, spp = UNSUPPORTED[name]
    cfg = RenderConfig() if overrides is None else dataclasses.replace(CFG, **overrides)
    scene, cam, _ = small_head_box(spp=spp)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pipeline.render_hdr(scene, cam, cfg)
    if spp == 1:
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        with pytest.raises(NotImplementedError, match="not ported yet"):
            pipeline.render_rays(scene, o, d, cfg)


def test_bad_inputs_raise():
    _, cam, tables = small_head_box()
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o.double(), d.double(), CFG)
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o[:, :2], d[:, :2], CFG)
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o, d[:5], CFG)
    px, py = cam.pixel_grid()
    with pytest.raises(ValueError):
        st.spp_trace(tables, cam, px.long(), py.long(), CFG)


def test_chain_grad_routes_cpu_to_plain():
    scene, cam, tables = small_head_box()
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    g = torch.from_numpy(np.random.default_rng(3).normal(size=o.shape).astype(np.float32))
    before = cg.chain_grad.launches
    cots, go, gd = cg.chain_grad(tables, o, d, g, CFG)
    assert cg.chain_grad.launches == before
    ref_cots, ref_go, ref_gd = cg.chain_grad_plain(tables, o, d, g, CFG)
    for a, b in zip((*cots, go, gd), (*ref_cots, ref_go, ref_gd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [c.shape for c in cots] == [t.shape for t in tables.tensors()]
    with pytest.raises(ValueError):
        cg.chain_grad(tables, o, d, g[:5], CFG)
    with pytest.raises(ValueError):
        cg.chain_grad(tables, o, d, g.double(), CFG)


def test_generator_seeds_the_render():
    scene, cam, _ = small_head_box(spp=3)
    g = lambda s: torch.Generator().manual_seed(s)
    a = pipeline.render_hdr(scene, cam, CFG, generator=g(1))
    b = pipeline.render_hdr(scene, cam, CFG, generator=g(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=g(1)))
    torch.testing.assert_close(a, pipeline.render_hdr(scene, cam, CFG, seed=seed), rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_requires_grad_raises(cuda_device):
    _, cam, tables = small_head_box(device=cuda_device)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    d = d.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ct.chain_trace(tables, o.contiguous(), d, CFG)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 4])
def test_cuda_kernels_match_plain(cuda_device, spp):
    scene, cam = builders.head_box_scene(width=64, height=48, spp=spp, device=cuda_device)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    px, py = cam.pixel_grid()
    if spp == 1:
        o, d = cam.rays_for_pixels(px, py)
        o = o.contiguous()
        before = ct.chain_trace.launches
        ours = ct.chain_trace(tables, o, d, CFG)
        assert ct.chain_trace.launches == before + 1
        ref = ct.trace_chain_plain(tables, o, d, CFG)
    else:
        before = st.spp_trace.launches
        ours = st.spp_trace(tables, cam, px, py, CFG, seed=9)
        assert st.spp_trace.launches == before + 1
        ref = st.spp_trace_plain(tables, cam, px, py, CFG, seed=9)
    torch.cuda.synchronize()
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"spp={spp}: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name", ["head_box", "spheres"])
def test_cuda_chain_grad_matches_plain(cuda_device, scene_name):
    """The adjoint kernel against chain_grad_plain at 64x48, on the head box
    and on baseline spheres (the sphere pullback). Ray cotangents under the
    seam budget with atol 1e-3 of the largest plain entry; table cotangents
    row by row (parity.table_cot_rows: fp32 sums in another order,
    shared-memory atomics)."""
    tables, o, d, g = grad_inputs(scene_name, 64, 48, cuda_device)
    before = cg.chain_grad.launches
    cots, go, gd = cg.chain_grad(tables, o, d, g, CFG)
    assert cg.chain_grad.launches == before + 1
    ref_cots, ref_go, ref_gd = cg.chain_grad_plain(tables, o, d, g, CFG)
    torch.cuda.synchronize()
    for name, ours, ref in (("d_o", go, ref_go), ("d_d", gd, ref_gd)):
        report = ray_cot_seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
        print(f"{name}: {report}")
        assert np.isfinite(ours.cpu().numpy()).all() and report.ok, (name, report)
    for name, ours, ref in zip(TABLE_ROWS, cots, ref_cots):
        assert ours.shape == ref.shape
        rows = table_cot_rows(name, ours.cpu().numpy(), ref.cpu().numpy())
        print("\n".join(map(str, rows)))
        assert all(r.ok for r in rows), [str(r) for r in rows if not r.ok]
    if scene_name == "spheres":
        assert float(ref_cots[0].abs().max()) > 0.0  # the sphere rows carry cotangents


@pytest.mark.gpu
@pytest.mark.parametrize("shadow_mode", ["binary", "march"])
def test_cuda_wavefront_trace_matches_plain(cuda_device, shadow_mode):
    """The wavefront kernel against trace_wavefront_plain on the glass
    sphere at 64x48 under the seam budget; render_hdr routes to it and
    gives the same frame; no push was dropped."""
    scene, cam = builders.glass_sphere_scene(64, 48, spp=1, device=cuda_device)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    cfg = RenderConfig(shadow_mode=shadow_mode, use_pallas=True)
    before = wt.wavefront_trace.launches
    ours = wt.wavefront_trace(tables, o, d, cfg)
    assert wt.wavefront_trace.launches == before + 1
    ref = wt.trace_wavefront_plain(tables, o, d, cfg)
    frame = pipeline.render_hdr(scene, cam, cfg)
    torch.cuda.synchronize()
    assert wt.wavefront_trace.launches == before + 2
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"{shadow_mode}: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
    torch.testing.assert_close(frame.reshape(-1, 3), ours, rtol=0, atol=1e-6)
    assert wt.dropped_pushes() == 0


@pytest.mark.gpu
def test_cuda_wavefront_spp_trace_matches_plain(cuda_device):
    """The wavefront AA kernel against its plain version, spp=4 at 64x48,
    one seed (the same Philox jitter bits)."""
    scene, cam = builders.glass_sphere_scene(64, 48, spp=4, device=cuda_device)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    px, py = cam.pixel_grid()
    cfg = RenderConfig(use_pallas=True)
    before = wt.wavefront_spp_trace.launches
    ours = wt.wavefront_spp_trace(tables, cam, px, py, cfg, seed=9)
    assert wt.wavefront_spp_trace.launches == before + 1
    ref = wt.wavefront_spp_trace_plain(tables, cam, px, py, cfg, seed=9)
    torch.cuda.synchronize()
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"spp=4: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
    assert wt.dropped_pushes() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shadow_mode", ["binary", "march"])
def test_cuda_wavefront_grad_matches_plain(cuda_device, shadow_mode):
    """The glass adjoint kernel against wavefront_grad_plain on the glass
    sphere at 64x64, g = d mean(img^2) / d img: ray cotangents under the
    seam budget at atol 1e-3 of the largest plain entry, table cotangents
    row by row (parity.table_cot_rows); the glass sphere's transparency and
    refractive index rows carry cotangents; no push was dropped."""
    scene, cam = builders.glass_sphere_scene(64, 64, spp=1, device=cuda_device)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    cfg = RenderConfig(shadow_mode=shadow_mode, use_pallas=True)
    img = wt.wavefront_trace(tables, o, d, cfg)
    g = (2.0 * img / img.numel()).contiguous()
    before = wg.wavefront_grad.launches
    cots, go, gd = wg.wavefront_grad(tables, o, d, g, cfg)
    assert wg.wavefront_grad.launches == before + 1
    ref_cots, ref_go, ref_gd = wg.wavefront_grad_plain(tables, o, d, g, cfg)
    torch.cuda.synchronize()
    for name, ours, ref in (("d_o", go, ref_go), ("d_d", gd, ref_gd)):
        report = ray_cot_seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
        print(f"{shadow_mode} {name}: {report}")
        assert np.isfinite(ours.cpu().numpy()).all() and report.ok, (name, report)
    for name, ours, ref in zip(TABLE_ROWS, cots, ref_cots):
        assert ours.shape == ref.shape
        rows = table_cot_rows(name, ours.cpu().numpy(), ref.cpu().numpy())
        print("\n".join(map(str, rows)))
        assert all(r.ok for r in rows), [str(r) for r in rows if not r.ok]
    mat = ref_cots[3].cpu().numpy()
    assert abs(mat[5, 0]) > 0.0 and abs(mat[6, 0]) > 0.0  # transparency, ior
    assert wt.dropped_pushes() == 0


@functools.lru_cache(maxsize=None)
def plain_table_cots(scene_name):
    tables, o, d, g = grad_inputs(scene_name, 16, 12, "cpu")
    return tuple(c.numpy() for c in cg.chain_grad_plain(tables, o, d, g, CFG)[0])


#: name -> (scene, table, row, wrong factor)
ROW_ERRORS = {
    "box_shininess_sign": ("head_box", "mat", "shininess", -1.0),
    "box_transparency_twice": ("head_box", "mat", "transparency", 2.0),
    "box_emission_half": ("head_box", "light", "emission.b", 0.5),
    "spheres_radius_sign": ("spheres", "sph", "r^2", -1.0),
    "spheres_shininess_twice": ("spheres", "mat", "shininess", 2.0),
}


@pytest.mark.parametrize("case", sorted(ROW_ERRORS))
def test_table_cot_rows_catch_one_wrong_row(case):
    """The adjoint's table budget, row by row: the plain cotangents pass
    against themselves, and one row off by a sign or a factor of 2 fails on
    that row alone, small rows (shininess) too."""
    scene_name, table, row, factor = ROW_ERRORS[case]
    for name, ref in zip(TABLE_ROWS, plain_table_cots(scene_name)):
        ours = ref.copy()
        if name == table:
            ours[TABLE_ROWS[table].index(row)] *= factor
        bad = [r.row for r in table_cot_rows(name, ours, ref) if not r.ok]
        assert bad == ([row] if name == table else []), (name, bad)


def test_roofline_work_counts():
    """The work counter behind chip_smoke.py's bounds: one bounce per ray at
    max_depth 1, each closest-hit scan between its all-early-exit and its
    all-full cost, at most one shadow ray per light, and the bound taken from
    the larger of the two times."""
    from raytracingengine_tpu_torch import roofline as rl

    _, cam, tables = small_head_box()
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    r = o.shape[0]
    w1 = rl.chain_work(tables, o.contiguous(), d, dataclasses.replace(CFG, max_depth=1))
    assert w1.bounces == r and 0 < w1.shadow_rays <= tables.n_lights * r
    per_scan = lambda plane, tri: rl.SCAN_SETUP + 5 * plane + 12 * tri  # noqa: E731
    low, high = per_scan(rl.PLANE_PARALLEL, rl.TRI_PARALLEL), per_scan(rl.PLANE_FULL, rl.TRI_FULL)
    assert r * low <= w1.closest_ops <= r * high
    assert 0 < w1.shadow_ops <= w1.shadow_rays * high
    w10 = rl.chain_work(tables, o.contiguous(), d, CFG)
    assert w10.bounces > w1.bounces and w10.closest_ops > w1.closest_ops
    assert rl.bound_ms(67e9, 1.0) == (1.0, "operations")
    assert rl.bound_ms(1.0, 3.35e9) == (1.0, "bytes")
