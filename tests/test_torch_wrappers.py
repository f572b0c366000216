"""PyTorch port, kernel wrappers and routing.

(h) A CPU tensor reaches the plain version and leaves the launch counter
unchanged; unsupported configurations raise NotImplementedError; bad
inputs raise (the forwards' tape and counts are the CUDA kernels'); the
glass adjoint's tape stretches follow the forward's per-warp counts. The
tests marked `gpu` need a CUDA card: they launch the kernels against their
plain versions (the adjoints fed from the taping and counting forwards,
directly and through the fused autograd Functions, and the wavefront
kernels on the glass sphere and, on culled tables, on a glass mesh too) and check that a forward kernel's CUDA
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
import raytracingengine_tpu_torch.roofline as rl
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.parity import (
    TABLE_ROWS,
    f64_factors_needed,
    ray_cot_seam_budget,
    seam_budget,
    sphere_rows_vs_f64,
    table_cot_rows,
    table_cot_rows_vs_f64,
)
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)


def small_head_box(spp=1, device="cpu"):
    scene, cam = builders.head_box_scene(width=8, height=6, spp=spp, device=device)
    return scene, cam, ct.pack_scene_tables(flatten_scene(scene))


def grad_inputs(scene_name, width, height, device, cfg=CFG):
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
    img = ct.chain_trace(tables, o, d, cfg)
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


#: name -> (config overrides, spp): the configurations that raised before
#: the per-sample loop, soft visibility and soft_primary were ported. At
#: spp > 1 every path without an AA kernel (chain mode with march or soft
#: shadows, soft_primary, use_pallas=False, the defaults) and every
#: differentiable one runs the loop.
UNSUPPORTED = {
    "wavefront": (dict(mode="wavefront", use_pallas=False), 3),
    "march": (dict(shadow_mode="march"), 3),
    "soft": (dict(shadow_mode="soft"), 3),
    "soft_primary": (dict(soft_primary=True), 3),
    "differentiable": (dict(differentiable=True), 3),
    "no_kernels": (dict(use_pallas=False), 3),
    "defaults": (None, 3),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_configs_raise(monkeypatch, name):
    """Each formerly unsupported configuration now renders, with gradients
    in the scene and through render_rays at spp=1, and reaches no in-kernel
    AA. What still raises: spp > 1 with gradients through the in-kernel
    AA (ValueError: it asks for differentiable=True), and a shadow mode or
    a render mode that does not exist."""
    overrides, spp = UNSUPPORTED[name]
    cfg = RenderConfig() if overrides is None else dataclasses.replace(CFG, **overrides)
    scene, cam, _ = small_head_box(spp=spp)
    aa_calls = []
    for module, fn in ((st, "spp_trace_plain"), (wt, "wavefront_spp_trace_plain")):
        monkeypatch.setattr(module, fn, lambda *a, **k: aa_calls.append(a))
    params, static = partition(scene)
    img = pipeline.render_hdr(combine(params, static), cam, cfg, seed=5)
    (img * img).mean().backward()
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all() and not aa_calls
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in params.values())
    assert float(params["triangles.materials.color"].grad.abs().max()) > 0
    if spp == 1:
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        with torch.no_grad():
            torch.testing.assert_close(pipeline.render_rays(scene, o, d, cfg), img.detach().reshape(-1, 3),
                                       rtol=1e-6, atol=1e-6)
    scene3, cam3, _ = small_head_box(spp=3)
    params, static = partition(scene3)
    with pytest.raises(ValueError, match="differentiable=True"):
        pipeline.render_hdr(combine(params, static), cam3, CFG)
    for bad in (dict(shadow_mode="hard"), dict(mode="path")):
        with pytest.raises(ValueError):
            pipeline.render_hdr(scene, cam, dataclasses.replace(CFG, **bad))


def test_bad_inputs_raise():
    _, cam, tables = small_head_box()
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o.double(), d.double(), CFG)
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o[:, :2], d[:, :2], CFG)
    with pytest.raises(ValueError):
        ct.chain_trace(tables, o, d[:5], CFG)
    with pytest.raises(ValueError, match="plain adjoint checkpoints itself"):
        ct.chain_trace(tables, o.contiguous(), d, CFG, tape=True)
    with pytest.raises(ValueError, match="plain adjoint tapes itself"):
        wt.wavefront_trace(tables, o.contiguous(), d, RenderConfig(use_pallas=True), count=True)
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
    with pytest.raises(ValueError, match="plain adjoint checkpoints itself"):
        cg.chain_grad(tables, o, d, g, CFG, tape=torch.zeros(1))


def test_glass_tape_slots_follow_the_warp_counts():
    """tape_slots: each warp's stretch starts where the previous one ends,
    a warp that popped nothing owns no slot, and a ragged last warp (70
    rays: 6 in warp 2) takes its count like any other; counts of the wrong
    length or type raise."""
    pops = torch.tensor([3, 0, 5], dtype=torch.int32)
    starts, total = wg.tape_slots(pops, 70)
    assert starts.tolist() == [0, 3, 3] and int(total) == 8
    starts, total = wg.tape_slots(torch.zeros(3, dtype=torch.int32), 65)
    assert starts.tolist() == [0, 0, 0] and int(total) == 0
    starts, total = wg.tape_slots(torch.zeros(0, dtype=torch.int32), 0)
    assert starts.numel() == 0 and int(total) == 0
    for bad, n in ((pops, 64), (pops, 97), (pops.long(), 70)):
        with pytest.raises(ValueError, match="warp_pops"):
            wg.tape_slots(bad, n)


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


def cuda_requires_grad_raises(cuda_device):
    _, cam, tables = small_head_box(device=cuda_device)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    d = d.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ct.chain_trace(tables, o.contiguous(), d, CFG)


def cuda_kernels_match_plain(cuda_device, spp):
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


def assert_grads_match(cots, go, gd, ref_cots, ref_go, ref_gd, case):
    """Ray cotangents under the seam budget with atol 1e-3 of the largest
    plain entry; table cotangents row by row (parity.table_cot_rows: fp32
    sums in another order, shared-memory atomics)."""
    for name, ours, ref in (("d_o", go, ref_go), ("d_d", gd, ref_gd)):
        report = ray_cot_seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
        print(f"{case} {name}: {report}")
        assert np.isfinite(ours.cpu().numpy()).all() and report.ok, (case, name, report)
    for name, ours, ref in zip(TABLE_ROWS, cots, ref_cots):
        assert ours.shape == ref.shape
        rows = table_cot_rows(name, ours.cpu().numpy(), ref.cpu().numpy())
        print("\n".join(map(str, rows)))
        assert all(r.ok for r in rows), (case, [str(r) for r in rows if not r.ok])


def cuda_chain_grad_matches_plain(cuda_device, scene_name):
    """The adjoint kernel, fed from the taping chain_trace, against
    chain_grad_plain on the head box and on baseline spheres (the sphere
    pullback): at 64x48 under the pixel-tile map and the identity map
    (`map_width` 0, which render_hdr takes when a chunk is not whole rows),
    at 37x29 (a ray count no multiple of 32, under the pixel-tile map) and
    at max_depth 1 (the depth-exhaustion sky follows the first bounce).
    Then the fused forward and backward (chain_trace_fused under autograd)
    under the same map: its taping forward's frame equals chain_trace's,
    its gradients are the plain adjoint's, and a second backward through
    the retained graph adds the same gradients again (the tape is kept):
    the ray cotangents bit for bit, the table cotangents within the
    shared-memory atomics' run-to-run spread (1e-4 of the largest entry)."""
    depth1 = dataclasses.replace(CFG, max_depth=1)
    for width, height, cfg, map_width in ((64, 48, CFG, 64), (64, 48, CFG, 0), (37, 29, CFG, 37),
                                          (64, 48, depth1, 64)):
        case = (scene_name, width, height, cfg.max_depth, map_width)
        tables, o, d, g = grad_inputs(scene_name, width, height, cuda_device, cfg)
        img, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
        torch.testing.assert_close(img, ct.chain_trace(tables, o, d, cfg), rtol=0, atol=0)
        before = cg.chain_grad.launches
        cots, go, gd = cg.chain_grad(tables, o, d, g, cfg, width=map_width, tape=tape)
        assert cg.chain_grad.launches == before + 1
        ref_cots, ref_go, ref_gd = cg.chain_grad_plain(tables, o, d, g, cfg)
        torch.cuda.synchronize()
        assert_grads_match(cots, go, gd, ref_cots, ref_go, ref_gd, case)
        if scene_name == "spheres":
            assert float(ref_cots[0].abs().max()) > 0.0  # the sphere rows carry cotangents
        # the fused forward and backward, as render_hdr runs them
        leaves = [t.clone().requires_grad_(True) for t in tables.tensors()]
        fused = dataclasses.replace(tables, sph=leaves[0], pl=leaves[1], tri=leaves[2],
                                    mat=leaves[3], light=leaves[4])
        o_req, d_req = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
        tapes, before = ct.chain_trace.tape_launches, cg.chain_grad.launches
        out = cg.chain_trace_fused(fused, o_req, d_req, cfg, map_width)
        torch.testing.assert_close(out.detach(), img, rtol=0, atol=0)
        (out * g).sum().backward(retain_graph=True)
        assert (ct.chain_trace.tape_launches, cg.chain_grad.launches) == (tapes + 1, before + 1)
        assert_grads_match([x.grad for x in leaves], o_req.grad, d_req.grad, ref_cots, ref_go,
                           ref_gd, (*case, "fused"))
        first = [x.grad.clone() for x in (*leaves, o_req, d_req)]
        (out * g).sum().backward()
        assert cg.chain_grad.launches == before + 2
        for a, x in zip(first[-2:], (o_req, d_req)):
            torch.testing.assert_close(x.grad, 2 * a, rtol=0, atol=0)
        for a, x in zip(first[:-2], leaves):
            spread = float((x.grad - 2 * a).abs().max())
            assert spread <= 1e-4 * float(a.abs().max()), (case, spread)


def glass_scene(width, height, spp, device, mesh: bool):
    """The glass sphere, or with `mesh` the same scene with
    dense_mesh_scene's bumpy mesh at ni=3, nj=33 (132 triangles: culled
    tables) made transparent (0.7, ior 1.3)."""
    scene, cam = builders.glass_sphere_scene(width, height, spp=spp, device=device)
    if not mesh:
        return scene, cam
    tri = builders.dense_mesh_scene(width, height, spp=spp, ni=3, nj=33, device=device)[0].triangles
    m = tri.materials
    mats = dataclasses.replace(m, transparency=torch.full_like(m.transparency, 0.7),
                               refractive_index=torch.full_like(m.refractive_index, 1.3))
    return dataclasses.replace(scene, triangles=dataclasses.replace(tri, materials=mats)), cam


def cuda_wavefront_trace_matches_plain(cuda_device, shadow_mode, mesh=False, size=(64, 48)):
    """The wavefront kernel against trace_wavefront_plain on the glass
    sphere at 64x48 (or `size`) under the seam budget; render_hdr routes to
    it and gives the same frame; no push was dropped. With `mesh`, on the
    glass mesh's culled tables (route "culled"), whose frame and counts
    equal the linear tables' bit for bit."""
    scene, cam = glass_scene(*size, 1, cuda_device, mesh)
    flat = flatten_scene(scene)
    tables = ct.pack_forward_tables_perm(flat)
    assert tables.culled == mesh
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    cfg = RenderConfig(shadow_mode=shadow_mode, use_pallas=True)
    before = wt.wavefront_trace.launches
    routes = dict(wt.wavefront_trace.routes)
    ours = wt.wavefront_trace(tables, o, d, cfg)
    assert wt.wavefront_trace.launches == before + 1
    assert wt.wavefront_trace.routes[wt.ROUTES[mesh]] == routes[wt.ROUTES[mesh]] + 1
    ref = wt.trace_wavefront_plain(tables, o, d, cfg)
    frame = pipeline.render_hdr(scene, cam, cfg)
    torch.cuda.synchronize()
    assert wt.wavefront_trace.launches == before + 2
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"{shadow_mode} mesh={mesh} {size}: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
    torch.testing.assert_close(frame.reshape(-1, 3), ours, rtol=0, atol=1e-6)
    if mesh:
        linear = ct.pack_scene_tables(flat)
        torch.testing.assert_close(wt.wavefront_trace(linear, o, d, cfg), ours, rtol=0, atol=0)
        counted = [wt.wavefront_trace(t, o, d, cfg, count=True) for t in (linear, tables)]
        torch.testing.assert_close(counted[0][1], counted[1][1], rtol=0, atol=0)
    assert wt.dropped_pushes() == 0


def cuda_wavefront_spp_trace_matches_plain(cuda_device, mesh=False, size=(64, 48)):
    """The wavefront AA kernel against its plain version, spp=4 at 64x48
    (or `size`), one seed (the same Philox jitter bits); with `mesh`, on the
    glass mesh's culled tables, equal to the linear tables' frame bit for
    bit."""
    scene, cam = glass_scene(*size, 4, cuda_device, mesh)
    flat = flatten_scene(scene)
    tables = ct.pack_forward_tables_perm(flat)
    px, py = cam.pixel_grid()
    cfg = RenderConfig(use_pallas=True)
    before = wt.wavefront_spp_trace.launches
    ours = wt.wavefront_spp_trace(tables, cam, px, py, cfg, seed=9)
    assert wt.wavefront_spp_trace.launches == before + 1
    ref = wt.wavefront_spp_trace_plain(tables, cam, px, py, cfg, seed=9)
    torch.cuda.synchronize()
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"spp=4 mesh={mesh} {size}: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
    if mesh:
        linear = wt.wavefront_spp_trace(ct.pack_scene_tables(flat), cam, px, py, cfg, seed=9)
        torch.testing.assert_close(linear, ours, rtol=0, atol=0)
    assert wt.dropped_pushes() == 0


def cuda_wavefront_grad_matches_plain(cuda_device, shadow_mode):
    """The glass adjoint kernel, fed from the counting wavefront_trace,
    against wavefront_grad_plain on the glass sphere, g = d mean(img^2) /
    d img: at 64x64, at 37x29 (1,073 rays: a ragged last warp) and in the
    deep-TIR configuration of the JAX package's adjoint tests (max_depth
    6, budget 100: trees the budget cuts). Ray cotangents under the seam
    budget at atol 1e-3 of the largest plain entry, table cotangents row
    by row (parity.table_cot_rows); the glass sphere's transparency and
    refractive index rows carry cotangents; no push was dropped. Counts one
    short in the warp that popped the most make the call raise (a lane's
    replay ran past its warp's stretch of the tape), or, with the check
    deferred as the autograd backward defers it, the backward pass; the
    next call, with the forward's counts, does not. Then the fused forward and
    backward (wavefront_trace_fused under autograd) on the ragged block.
    Last, the opaque sphere made a mirror (specular 0.5): its hits push a
    reflection child with transparency 0, the other arm of the forward
    kernels' test for whether a hit can push a child; both frames are held
    to trace_wavefront_plain and the counts size the adjoint's tape."""
    base = RenderConfig(shadow_mode=shadow_mode, use_pallas=True)
    deep = dataclasses.replace(base, max_depth=6, wavefront_budget=100)
    for width, height, cfg, mirror in ((64, 64, base, False), (37, 29, base, False),
                                       (64, 64, deep, False), (64, 64, base, True)):
        case = (shadow_mode, width, height, cfg.max_depth, "mirror" if mirror else "glass")
        scene, cam = builders.glass_sphere_scene(width, height, spp=1, device=cuda_device)
        tables = ct.pack_scene_tables(flatten_scene(scene))
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        o = o.contiguous()
        if mirror:
            glass_pops = rl.wavefront_work(tables, o, d, cfg).pops
            mirror_mat = tables.mat.clone()
            mirror_mat[TABLE_ROWS["mat"].index("specular"), 1] = 0.5  # sphere 1, the opaque one
            tables = dataclasses.replace(tables, mat=mirror_mat)
        img, warp_pops = wt.wavefront_trace(tables, o, d, cfg, count=True)
        torch.testing.assert_close(img, wt.wavefront_trace(tables, o, d, cfg), rtol=0, atol=0)
        assert warp_pops.shape == ((width * height + 31) // 32,) and int(warp_pops.min()) >= 1
        if mirror:  # the mirror's reflections pop, and the frame is the plain version's
            assert rl.wavefront_work(tables, o, d, cfg).pops > glass_pops, case
            report = seam_budget(img.cpu().numpy(), wt.trace_wavefront_plain(tables, o, d, cfg).cpu().numpy())
            print(f"{case} frame: {report}")
            assert report.ok, (case, report)
        g = (2.0 * img / img.numel()).contiguous()
        before = wg.wavefront_grad.launches
        cots, go, gd = wg.wavefront_grad(tables, o, d, g, cfg, warp_pops=warp_pops)
        assert wg.wavefront_grad.launches == before + 1
        ref_cots, ref_go, ref_gd = wg.wavefront_grad_plain(tables, o, d, g, cfg)
        torch.cuda.synchronize()
        assert_grads_match(cots, go, gd, ref_cots, ref_go, ref_gd, case)
        mat = ref_cots[3].cpu().numpy()
        assert abs(mat[5, 0]) > 0.0 and abs(mat[6, 0]) > 0.0  # transparency, ior
        assert wt.dropped_pushes() == 0, case
        if cfg is base and width == 64:  # a tape overrun raises in its own call
            short = warp_pops.clone()
            short[int(short.argmax())] -= 1
            with pytest.raises(RuntimeError, match="popped more nodes"):
                wg.wavefront_grad(tables, o, d, g, cfg, warp_pops=short)

            def adjoint_in_backward(grad):  # as WavefrontTraceFused.backward calls it
                wg.wavefront_grad(tables, o, d, g, cfg, warp_pops=short, defer_check=True)
                return grad

            x = torch.zeros(1, device=cuda_device, requires_grad=True)
            y = x * 1.0
            y.register_hook(adjoint_in_backward)
            with pytest.raises(RuntimeError, match="popped more nodes"):
                y.sum().backward()
        if (width, height) == (37, 29):  # the fused forward and backward
            leaves = [t.clone().requires_grad_(True) for t in tables.tensors()]
            fused = dataclasses.replace(tables, sph=leaves[0], pl=leaves[1], tri=leaves[2],
                                        mat=leaves[3], light=leaves[4])
            o_req, d_req = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
            counting = wt.wavefront_trace.count_launches
            out = wg.wavefront_trace_fused(fused, o_req, d_req, cfg)
            torch.testing.assert_close(out.detach(), img, rtol=0, atol=0)
            (out * g).sum().backward()
            assert wt.wavefront_trace.count_launches == counting + 1
            assert_grads_match([x.grad for x in leaves], o_req.grad, d_req.grad, ref_cots, ref_go,
                               ref_gd, (*case, "fused"))


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
    that row alone, small rows (shininess) too; so against a float64
    reference, with the factor each row needs. Once, the sphere rows'
    float64 comparison on baseline spheres."""
    scene_name, table, row, factor = ROW_ERRORS[case]
    for name, ref in zip(TABLE_ROWS, plain_table_cots(scene_name)):
        ours = ref.copy()
        if name == table:
            ours[TABLE_ROWS[table].index(row)] *= factor
        bad = [r.row for r in table_cot_rows(name, ours, ref) if not r.ok]
        assert bad == ([row] if name == table else []), (name, bad)
        # Against a float64 reference: with the float32 plain version on it
        # the bound is table_cot_rows'; a float32 plain version as far off
        # as the kernel widens it to let the kernel through.
        assert [r.row for r in table_cot_rows_vs_f64(name, ours, ref, ref) if not r.ok] == bad
        assert all(r.ok for r in table_cot_rows_vs_f64(name, ours, ours, ref))
        # The factor each row needs: none where it passes alone, no factor
        # where the float32 plain version sits on float64, less than 1
        # where it is as far off as the kernel.
        need = f64_factors_needed(name, ours, ref, ref)
        assert need == [np.inf if r in bad else 0.0 for r in TABLE_ROWS[name]], (name, need)
        assert max(f64_factors_needed(name, ours, ours, ref)) < 1.0
    if case == "spheres_radius_sign":  # the sphere rows against float64, on the CPU
        tables, o, d, g = grad_inputs("spheres", 16, 12, "cpu")
        ref = cg.chain_grad_plain(tables, o, d, g, CFG)
        rows, seam, seam64 = sphere_rows_vs_f64(tables, o, d, g, CFG, ref, ref)
        np.testing.assert_array_equal(rows[0], rows[1])  # on the CPU chain_grad is the plain version
        np.testing.assert_allclose(rows[0], plain_table_cots("spheres")[0], rtol=0, atol=0)
        assert not bool(seam.any()) and all(r.ok for r in table_cot_rows_vs_f64("sph", *rows))
        assert np.abs(rows[1] - rows[2]).max() > 0.0, int(seam64.sum())  # float64 is another sum


def test_roofline_work_counts():
    """The work counter behind chip_smoke.py's bounds: one bounce per ray at
    max_depth 1, each closest-hit scan between its all-early-exit and its
    all-full cost, at most one shadow ray per light, none to a padded light
    slot (the head box padded to 8 slots a family sends as many shadow rays
    as the head box), and the bound taken from the larger of the two times."""
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
    padded, _ = builders.head_box_scene(width=8, height=6, pad_multiple=8, device="cpu")
    p_tables = ct.pack_scene_tables(flatten_scene(padded))
    assert p_tables.n_lights == 8 and int(p_tables.light[6].sum()) == tables.n_lights
    wp = rl.chain_work(p_tables, o.contiguous(), d, CFG)
    assert (wp.bounces, wp.shadow_rays) == (w10.bounces, w10.shadow_rays)
    assert rl.bound_ms(67e9, 1.0) == (1.0, "operations")
    assert rl.bound_ms(1.0, 3.35e9) == (1.0, "bytes")

    # The glass kernels' shading: every pop is a sky node or a shaded one,
    # each shaded node adds at most its sphere normal, node_children and,
    # per light, the shadow ray's set-up and the lit and specular terms
    # (node_children only off the glass sphere here: the floor and the
    # opaque sphere push no child); the camera ray of an AA sample counts
    # per ray, its screen point with sample 0 only (once per pixel), its
    # jitter past sample 0 only.
    scene, gcam = builders.glass_sphere_scene(8, 6, spp=1, device="cpu")
    g_tables = ct.pack_scene_tables(flatten_scene(scene))
    go, gd = (x.contiguous() for x in gcam.rays_for_pixels(*gcam.pixel_grid()))
    glass_cfg = RenderConfig(use_pallas=True)
    gw = rl.wavefront_work(g_tables, go, gd, glass_cfg)
    per_light = rl.LIGHT_SETUP + rl.LIGHT_LIT + rl.LIGHT_SPEC
    most = rl.SHADE_NODE + rl.SPHERE_NORMAL + rl.CHILDREN + g_tables.n_lights * per_light
    assert gw.pops >= r and gw.march_steps > 0
    assert gw.pops * rl.SKY_NODE <= gw.shade_ops - rl.MARCH_STEP * gw.march_steps <= gw.pops * most
    sky_only = dataclasses.replace(glass_cfg, max_depth=0)  # every node a sky node
    assert rl.wavefront_work(g_tables, go, gd, sky_only).shade_ops == rl.SKY_NODE * go.shape[0]
    assert 0 < gw.mufu_ops <= gw.pops * (rl.CHILDREN_MUFU + rl.SPHERE_NORMAL_MUFU + g_tables.n_lights * (
        rl.LIGHT_SETUP_MUFU + rl.LIGHT_LIT_MUFU + rl.LIGHT_SPEC_MUFU)) and gw.int_ops == 0
    for sample, jitter in ((0, 0), (1, 1), (3, 1)):
        gs = rl.wavefront_work(g_tables, go, gd, glass_cfg, camera_sample=sample)
        rays = go.shape[0]
        per_sample = rl.CAMERA + (rl.JITTER if jitter else rl.CAMERA_PIXEL)
        assert gs.shade_ops - gw.shade_ops == per_sample * rays
        assert gs.mufu_ops - gw.mufu_ops == rl.CAMERA_MUFU * rays
        assert gs.int_ops == rl.PHILOX_INT * jitter * rays
    fp32_ms, by = rl.wavefront_bound_ms(gw, 0.0)
    assert by == "fp32 operations" and fp32_ms == pytest.approx(
        1e3 * (rl.work_ops(gw) + gw.shade_ops) / rl.H100_FP32_OPS_PER_S)
    assert rl.wavefront_bound_ms(gw, 3.35e9) == (1.0, "bytes")
    assert rl.wavefront_bound_ms(rl.WavefrontWork(rays=1, mufu_ops=67e9 / 16), 0.0) == (1.0, "MUFU operations")
    assert rl.wavefront_bound_ms(rl.WavefrontWork(rays=1, int_ops=67e9 / 4), 0.0) == (1.0, "integer operations")

    # The glass kernels' culled scans (the glass mesh, 132 triangles): the
    # closest-hit and march scans test no more real triangles than on linear
    # tables, and as many when every box is met; the same trees; a warp's
    # union holds each of its lanes' blocks. The warp-cooperative scan's
    # turns: the lanes' visited blocks (the traversal's running bound visits
    # at least the blocks of the final hit's segment, and every block when
    # every box is met) and the warps' votes (with every box met, each
    # warp's scan votes once for each block, where a loop per lane turns 32
    # times for each).
    m_scene, m_cam = glass_scene(8, 6, 1, "cpu", mesh=True)
    m_flat = flatten_scene(m_scene)
    mo, md = (x.contiguous() for x in m_cam.rays_for_pixels(*m_cam.pixel_grid()))
    m_cfg = RenderConfig(use_pallas=True, max_depth=3)
    culled = ct.pack_forward_tables_perm(m_flat)
    everywhere = culled.taabb.clone()
    everywhere[:3], everywhere[3:] = -1e30, 1e30
    lin, cul, met = (rl.wavefront_work(t, mo, md, m_cfg) for t in (
        ct.pack_scene_tables(m_flat), culled, dataclasses.replace(culled, taabb=everywhere)))
    assert lin.pops == cul.pops == met.pops and lin.march_steps == cul.march_steps > 0
    assert 0 < cul.closest_tris < lin.closest_tris == met.closest_tris
    assert lin.lane_blocks == lin.warp_blocks == 0 and 0 < cul.lane_blocks <= cul.warp_blocks
    assert cul.lane_blocks < met.lane_blocks <= met.warp_blocks
    assert 0 < rl.work_ops(cul) < rl.work_ops(lin) and cul.shade_ops == lin.shade_ops
    assert lin.visit_blocks == lin.vote_blocks == lin.coop_blocks == 0
    assert 0 < cul.lane_blocks <= cul.visit_blocks < cul.coop_blocks == cul.visit_blocks + cul.vote_blocks
    assert met.visit_blocks == met.lane_blocks and met.warp_blocks == 32 * met.vote_blocks


@pytest.mark.gpu
def test_cuda_wrappers_match_plain(cuda_device):
    """Every check of this file on the card, one after another: one test item,
    since off the card it skips (chip_smoke.py covers each on the main paths' shapes)."""
    cuda_requires_grad_raises(cuda_device)
    for spp in (1, 4):
        cuda_kernels_match_plain(cuda_device, spp)
    for scene_name in ('head_box', 'spheres'):
        cuda_chain_grad_matches_plain(cuda_device, scene_name)
    for mesh in (False, True):
        for shadow_mode in ('binary', 'march'):
            cuda_wavefront_trace_matches_plain(cuda_device, shadow_mode, mesh)
        cuda_wavefront_spp_trace_matches_plain(cuda_device, mesh)
    # 61x47 rays: the culled kernels' last warp has lanes past the end
    for shadow_mode in ('binary', 'march'):
        cuda_wavefront_trace_matches_plain(cuda_device, shadow_mode, mesh=True, size=(61, 47))
    cuda_wavefront_spp_trace_matches_plain(cuda_device, mesh=True, size=(61, 47))
    for shadow_mode in ('binary', 'march'):
        cuda_wavefront_grad_matches_plain(cuda_device, shadow_mode)
