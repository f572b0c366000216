"""PyTorch port, the dense- and streamed-mesh path: culling tables, the
culled chain scan and the dense adjoint, against the JAX package on the CPU.

Every JAX reference is an XLA function: the builders, the pure-jnp packing
functions of kernels/chain_trace.py, integrate_chain and jax.grad of it;
never a Pallas kernel in interpret mode. Two gradient compiles in all,
shared through module-scoped fixtures. Tolerances:

  * builders and packing: exact (float64 mesh; permutations, integers and
    boxes equal). The triangles' unit normals (tri rows 9-11) are the one
    exception: flatten_scene's normalize rounds its reciprocal square root
    differently in the two packages (1 ulp), so those rows are held to the
    port's own pack_scene_tables exactly and to JAX's at 2.5e-7;
  * the culled plain forward equals the authoring-order one exactly (the
    (t, original index) rule makes the visit order irrelevant), and both
    hold to JAX integrate_chain under parity.seam_budget;
  * the dense plain adjoint equals chain_grad_plain where both apply, rtol
    1e-5 and atol 1e-6 of each table's largest entry (the same arithmetic,
    summed in another order);
  * gradients through the entry points: every float leaf within rtol 5e-3
    and atol 2e-3 of its largest entry
    (tests/test_streamed.py:120-121: fp32 sums of many rays in other
    orders), ray cotangents by origin_cot_ok and direction_cot_ok.

The tests marked `gpu` launch the culled forward kernels and the dense
adjoint on a CUDA card against their plain versions; they skip here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingengine_tpu.kernels.chain_trace as jct
import raytracingengine_tpu_torch.kernels.chain_grad as cg
import raytracingengine_tpu_torch.kernels.chain_trace as ct
import raytracingengine_tpu_torch.kernels.spp_trace as st
from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.geometry.materials import Material as JaxMaterial
from raytracingengine_tpu.render.integrator import integrate_chain as jax_integrate_chain
from raytracingengine_tpu.scene import SceneBuilder as JaxSceneBuilder
from raytracingengine_tpu.scenes import assets as jax_assets
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.convert import scene_from_numpy
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.inverse import combine, partition
from raytracingengine_tpu_torch.parity import (
    TABLE_ROWS,
    direction_cot_ok,
    grad_leaf_mismatches,
    origin_cot_ok,
    ray_cot_seam_budget,
    seam_budget,
    table_cot_rows,
)
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import mean_direction, render_hdr, render_rays
from raytracingengine_tpu_torch.scene import SceneBuilder
from raytracingengine_tpu_torch.scenes import assets, builders
from jax_refs import jit_o0

torch.set_num_threads(2)

#: name -> (builder, kwargs): the scrambled 1,080-triangle mesh (16 blocks,
#: 2 groups, padded columns), the same in authoring order, and every
#: primitive family with the mesh.
SCENES = {
    "dense_scrambled": ("dense_mesh_scene", dict(ni=16, nj=36, scramble=7)),
    "dense": ("dense_mesh_scene", dict(ni=16, nj=36)),
    "mixed": ("mixed_dense_scene", {}),
}


def jax_leaves(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


def torch_leaves(obj, prefix="") -> dict[str, np.ndarray]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(torch_leaves(v, f"{prefix}{f.name}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{f.name}"] = v.numpy()
    return out


def build_pair(name, size=8, **extra):
    fn, kw = SCENES[name]
    j_scene, j_cam = getattr(jax_builders, fn)(width=size, height=size, **kw, **extra)
    t_scene, t_cam = getattr(builders, fn)(width=size, height=size, **kw, **extra, device="cpu")
    return (j_scene, j_cam), (t_scene, t_cam)


def test_bumpy_sphere_mesh_matches_jax():
    for kw in ({}, dict(ni=16, nj=36), dict(radius=1.5, ni=5, nj=7, amp=0.3)):
        verts, idx = assets.bumpy_sphere_mesh(**kw)
        j_verts, j_idx = jax_assets.bumpy_sphere_mesh(**kw)
        assert verts.dtype == np.float64 and idx.dtype == np.int64
        np.testing.assert_array_equal(verts, j_verts)
        np.testing.assert_array_equal(idx, j_idx)
    assert idx.size // 3 == 7 * (2 * 5 - 2)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_dense_builders_match_jax(name):
    (j_scene, j_cam), (t_scene, t_cam) = build_pair(name)
    ref = jax_leaves(j_scene)
    carried = scene_from_numpy(ref, has_transparency=j_scene.has_transparency, device="cpu")
    for ours in (torch_leaves(t_scene), torch_leaves(carried)):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert torch_leaves(t_cam).keys() == jax_leaves(j_cam).keys()
    for k, v in jax_leaves(j_cam).items():
        np.testing.assert_array_equal(torch_leaves(t_cam)[k], v, err_msg=k)
    assert t_scene.has_transparency == j_scene.has_transparency


@pytest.mark.parametrize("nt", [1, 127, 128, 129, 1023, 1024, 1025, 1080, 6016, 50800])
def test_n_culling_blocks_matches_jax(nt):
    assert ct.n_culling_blocks(nt) == jct.n_culling_blocks(nt)
    assert ct.n_culling_blocks(nt) % ct.TRI_GROUP == 0
    assert (ct.TRI_BLOCK, ct.TRI_GROUP) == (jct.TRI_BLOCK, jct.TRI_GROUP)


def flats(name):
    (j_scene, _), (t_scene, _) = build_pair(name)
    return jax_flatten(j_scene), flatten_scene(t_scene)


#: The front-to-back direction of the packing tests.
DMEAN = (0.3, -0.2, 0.93)


@functools.lru_cache(maxsize=None)
def jax_packing(name):
    """-> the JAX package's packing of scene `name`, one jitted call: the
    Morton and median-split orders, the block boxes in authoring and split
    order, and pack_forward_tables_perm without and with DMEAN."""
    j_flat, _ = flats(name)

    @jit_o0
    def pack(flat, dmean):
        split = jct.triangle_split_perm(flat)
        boxes = (jct.pack_tri_aabbs(flat), jct.pack_tri_aabbs(flat, perm=split))
        return (jct.triangle_morton_perm(flat), split, boxes,
                tuple(jax.tree.map(jnp.asarray, jct.pack_forward_tables_perm(flat, dm)) for dm in (None, dmean)))

    dmean = jnp.asarray(DMEAN, jnp.float32)
    return jax.tree.map(np.asarray, pack(j_flat, dmean / jnp.linalg.norm(dmean)))


@pytest.mark.parametrize("name", ["dense_scrambled", "mixed"])
def test_packing_functions_match_jax(name):
    """The orders, the block and group boxes and the surface-area sum."""
    _, t_flat = flats(name)
    morton, split, boxes, _ = jax_packing(name)
    for fn, ref in (("triangle_morton_perm", morton), ("triangle_split_perm", split)):
        ours = getattr(ct, fn)(t_flat).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=fn)
        assert sorted(ours) == list(range(t_flat.n_triangles))
    for p, ref in zip((None, ct.triangle_split_perm(t_flat)), boxes):
        ours = ct.pack_tri_aabbs(t_flat, perm=p)
        np.testing.assert_array_equal(ours.numpy(), ref)
        np.testing.assert_array_equal(ct.pack_group_aabbs(ours).numpy(),
                                      np.asarray(jct.pack_group_aabbs(jnp.asarray(ref))))
        np.testing.assert_allclose(float(ct._block_sa_sum(ours)),
                                   float(jct._block_sa_sum(jnp.asarray(ref))), rtol=1e-6)
    # a padded block box is a far point and never widens its group's box
    padded = torch.cat([ct.pack_tri_aabbs(t_flat), torch.full((6, 3), ct._FAR)], 1)
    np.testing.assert_array_equal(ct.pack_group_aabbs(padded)[:, -1].numpy(),
                                  ct.pack_group_aabbs(ct.pack_tri_aabbs(t_flat))[:, -1].numpy())


@pytest.mark.parametrize("with_dmean", [False, True])
@pytest.mark.parametrize("name", ["dense_scrambled", "mixed"])
def test_pack_forward_tables_perm_matches_jax(name, with_dmean):
    _, t_flat = flats(name)
    dmean = torch.tensor(DMEAN) / torch.tensor(DMEAN).norm() if with_dmean else None
    (j_sph, j_pl, j_tri, j_taabb, j_mat, j_light), j_perm = jax_packing(name)[3][int(with_dmean)]
    T = ct.pack_forward_tables_perm(t_flat, dmean)
    nt, nb = t_flat.n_triangles, ct.n_culling_blocks(t_flat.n_triangles)
    assert T.culled and T.n_blocks == nb == 16 and T.tri.shape == (13, nb * ct.TRI_BLOCK)
    assert T.taabb.shape == (6, nb + nb // ct.TRI_GROUP)
    np.testing.assert_array_equal(T.perm.numpy(), j_perm)
    np.testing.assert_array_equal(T.taabb.numpy(), j_taabb)
    exact = [r for r in range(13) if r not in (9, 10, 11)]
    np.testing.assert_array_equal(T.tri[exact].numpy(), j_tri[exact])
    np.testing.assert_allclose(T.tri[9:12].numpy(), j_tri[9:12], rtol=0, atol=2.5e-7)
    plain = ct.pack_scene_tables(t_flat)
    valid = T.perm >= 0
    assert int(valid.sum()) == nt and (T.tri[12, ~valid] == 2.0**30).all()
    np.testing.assert_array_equal(T.tri[:12, valid].numpy(), plain.tri[:, T.perm[valid]].numpy())
    assert (T.tri[:12, ~valid] == 0).all()
    for ours, ref in zip((T.sph, T.pl, T.mat, T.light), (j_sph, j_pl, j_mat, j_light)):
        np.testing.assert_array_equal(ours.numpy(), ref)
    # the reorder is an index: the packed rows' cotangents land on the
    # authoring-order triangles
    v0 = t_flat.tri_v0.clone().requires_grad_(True)
    packed = ct.pack_forward_tables_perm(dataclasses.replace(t_flat, tri_v0=v0), dmean)
    assert packed.tri.requires_grad and not packed.taabb.requires_grad
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(12, nb * ct.TRI_BLOCK)).astype(np.float32))
    (g,) = torch.autograd.grad((packed.tri[:12] * w).sum(), v0)
    v0_ref = t_flat.tri_v0.clone().requires_grad_(True)
    ref_tri = ct.pack_scene_tables(dataclasses.replace(t_flat, tri_v0=v0_ref)).tri
    (g_ref,) = torch.autograd.grad((ref_tri[:, T.perm[valid]] * w[:, valid]).sum(), v0_ref)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=0)


def test_culled_forward_equals_authoring_order_and_jax():
    """trace_chain_plain on the culled tables equals it on the authoring-
    order tables exactly; both against JAX integrate_chain (jitted) under
    the seam budget. The scrambled mesh at 8x8, max_depth 3."""
    (j_scene, j_cam), (t_scene, t_cam) = build_pair("dense_scrambled")
    o, d = t_cam.rays_for_pixels(*t_cam.pixel_grid())
    cfg = RenderConfig(shadow_mode="binary", max_depth=3, use_pallas=True)
    flat = flatten_scene(t_scene)
    culled = ct.pack_forward_tables_perm(flat, mean_direction(d))
    ours = ct.chain_trace(culled, o.contiguous(), d, cfg)
    ref = ct.trace_chain_plain(ct.pack_scene_tables(flat), o, d, cfg)
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    jcfg = JaxConfig(shadow_mode="binary", max_depth=3)
    jo, jd = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    j_img = np.asarray(jit_o0(lambda s: jax_integrate_chain(jax_flatten(s), jo, jd, jcfg))(j_scene))
    report = seam_budget(ours.numpy(), j_img)
    assert report.ok and np.isfinite(ours.numpy()).all(), report
    assert float(ours.std()) > 0.05  # the mesh, the floor and the sky are all in view
    # spp > 1: the AA loop on culled tables (a 144-triangle mesh, 4x4, spp=2)
    scene2, cam2 = builders.dense_mesh_scene(4, 4, spp=2, ni=4, nj=24, scramble=7, device="cpu")
    flat2 = flatten_scene(scene2)
    px, py = cam2.pixel_grid()
    a = st.spp_trace(ct.pack_forward_tables_perm(flat2), cam2, px, py, cfg, seed=5)
    b = st.spp_trace_plain(ct.pack_scene_tables(flat2), cam2, px, py, cfg, seed=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def adjoint_inputs(scene, cam, cfg):
    flat = flatten_scene(scene)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    o = o.contiguous()
    plain = ct.pack_scene_tables(flat)
    img = ct.chain_trace(plain, o, d, cfg)
    return flat, plain, o, d, (2.0 * img / img.numel()).contiguous()


@pytest.mark.parametrize("name", ["head_box", "mesh336"])
def test_dense_adjoint_plain_matches_chain_grad_plain(name):
    """Where both adjoints apply: the head box (12 triangles, tables not
    culled) and a 336-triangle mesh (culled tables, the triangle rows
    carried back to authoring order by perm). 10x10, max_depth 3."""
    if name == "head_box":
        scene, cam = builders.head_box_scene(10, 10, spp=1, device="cpu")
    else:
        scene, cam = builders.dense_mesh_scene(10, 10, ni=8, nj=24, device="cpu")
    cfg = RenderConfig(shadow_mode="binary", max_depth=3, use_pallas=True)
    flat, plain, o, d, g = adjoint_inputs(scene, cam, cfg)
    ref, ref_go, ref_gd = cg.chain_grad_plain(plain, o, d, g, cfg)
    tables = ct.pack_forward_tables_perm(flat, mean_direction(d))
    assert tables.culled == (name == "mesh336")
    before = cg.chain_grad_dense.launches
    cots, go, gd = cg.chain_grad_dense(tables, o, d, g, cfg)
    assert cg.chain_grad_dense.launches == before  # CPU: the plain version
    cots = list(cots)
    if tables.culled:
        assert (cots[2][12] == 0).all() and (cots[2][:, tables.perm < 0] == 0).all()
        tri = torch.zeros_like(plain.tri)
        valid = tables.perm >= 0
        tri[:, tables.perm[valid]] = cots[2][:12, valid]
        cots[2] = tri
    for table, a, b in zip(TABLE_ROWS, cots, ref):
        assert a.shape == b.shape, table
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale + 1e-30, msg=table)
    assert float(ref[2].abs().max()) > 0 and float(ref[3].abs().max()) > 0
    torch.testing.assert_close(go, ref_go, rtol=1e-5, atol=1e-6 * float(ref_go.abs().max()))
    torch.testing.assert_close(gd, ref_gd, rtol=1e-5, atol=1e-6 * float(ref_gd.abs().max()))


def _grazing_triangle(angle):
    """float32 (v0, e1, e2, o, d): a 0.05-sized triangle 15.7 along the ray,
    whose plane the ray meets at `angle` radians."""
    f64 = torch.float64
    d = torch.tensor([0.0154582, 0.14492, 0.989323], dtype=f64)
    d = d / d.norm()
    o = torch.tensor([0.0, 0.0, -8.0], dtype=f64)
    u = torch.linalg.cross(d, torch.tensor([1.0, 0.0, 0.0], dtype=f64))
    u = u / u.norm()
    along = d * np.cos(angle) + torch.linalg.cross(u, d) * np.sin(angle)
    e1, e2 = 0.046 * along, 0.055 * (0.6 * u + 0.8 * along)
    v0 = o + 15.7 * d - 0.3 * e1 - 0.3 * e2
    return [x.to(torch.float32) for x in (v0, e1, e2, o, d)]


def _expanded_t(v0, e1, e2, o, d):
    """Moller-Trumbore's t = f (e2 . ((o - v0) x e1)), f = 1 / (e1 . (d x e2))."""
    f = 1.0 / (e1 * torch.linalg.cross(d, e2)).sum()
    return f * (e2 * torch.linalg.cross(o - v0, e1)).sum()


def _plane_grads(dtype, t0, *cols):
    leaves = [x.to(dtype).requires_grad_(True) for x in cols]
    v0, e1, e2, o, d = leaves
    t = cg._tri_t_plane(torch.tensor(t0, dtype=dtype), tuple(v0), tuple(e1), tuple(e2), *o, *d)
    assert float(t.detach()) == t0
    return torch.autograd.grad(t, leaves)


@pytest.mark.parametrize("case", ["derivation", "grazing"])
def test_tri_plane_form_gradient(case):
    """`_tri_t_plane` (and the kernels' tri_pullback, which computes the same
    form) keeps the forward's t and differentiates the plane through v0.
    derivation: in float64 on a ray 0.5 rad off the plane, its gradient in
    v0, e1, e2, o and d equals autograd of the expanded Moller-Trumbore t
    (rtol 1e-9). grazing: 1e-3 rad off the plane, where e1 . (d x e2) is a
    cancellation, float32 stays within 5e-4 of float64 at the same t (the
    form's one subtraction, s + t d, costs ~|s| / |p - v0| = 300 ulps)."""
    if case == "derivation":
        cols = [x.double() for x in _grazing_triangle(0.5)]
        leaves = [x.clone().requires_grad_(True) for x in cols]
        t = _expanded_t(*leaves)
        ref = torch.autograd.grad(t, leaves)
        ours = _plane_grads(torch.float64, float(t.detach()), *cols)
        rtol = 1e-9
    else:
        cols = _grazing_triangle(1e-3)
        with torch.no_grad():
            t0 = float(_expanded_t(*cols))
        ref = _plane_grads(torch.float64, t0, *cols)
        ours = _plane_grads(torch.float32, t0, *cols)
        rtol = 5e-4
    for name, a, b in zip(("v0", "e1", "e2", "o", "d"), ours, ref):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= rtol, (name, err)


#: name -> (port builder, kwargs, max_depth): the scenes of the gradient
#: references. "mixed" is the configuration of tests/test_streamed.py's
#: streamed-adjoint test (619 primitives); "dense" that of
#: tests/test_chain_grad.py::test_ray_grads_blocked_adjoint.
GRAD_SCENES = {
    "mixed": ("mixed_dense_scene", dict(ni=12, nj=28), 2),
    "dense": ("dense_mesh_scene", dict(ni=16, nj=36), 3),
}


@pytest.fixture(scope="module")
def jax_grads():
    """name -> (o, d, image, float scene-leaf grads, d_o, d_d) of sum(img^2)
    through XLA autodiff of JAX integrate_chain, one compile per scene."""
    out = {}

    def reference(name):
        if name not in out:
            fn, kw, depth = GRAD_SCENES[name]
            scene, cam = getattr(jax_builders, fn)(width=8, height=8, spp=1, **kw)
            o, d = cam.rays_for_pixels(*cam.pixel_grid())
            cfg = JaxConfig(shadow_mode="binary", max_depth=depth)

            def img_and_grads(s, oo, dd):
                img, vjp = jax.vjp(lambda s, oo, dd: jax_integrate_chain(jax_flatten(s), oo, dd, cfg),
                                   s, oo, dd)
                return img, vjp(2.0 * img)

            img, (g_scene, g_o, g_d) = jit_o0(img_and_grads)(scene, o, d)
            grads = {k: v for k, v in jax_leaves(g_scene).items() if np.issubdtype(v.dtype, np.floating)}
            out[name] = (np.array(o), np.array(d), np.asarray(img), grads, np.asarray(g_o), np.asarray(g_d))
        return out[name]

    return reference


def leaf_errors(ours, ref):
    """Every float leaf within rtol 5e-3 and atol 2e-3 of its largest
    reference entry (tests/test_streamed.py:120-121) -> violations."""
    assert sorted(ours) == sorted(ref)
    errors = []
    for k, b in ref.items():
        a = ours[k]
        if a.shape != b.shape:
            errors.append(f"{k}: shape {a.shape} != {b.shape}")
        elif b.size:
            bad = ~(np.abs(a - b) <= 2e-3 * (np.abs(b).max() + 1e-6) + 5e-3 * np.abs(b))
            if bad.any():
                errors.append(f"{k}: {int(bad.sum())} entries off")
    return errors


def port_scene(name):
    fn, kw, depth = GRAD_SCENES[name]
    scene, cam = getattr(builders, fn)(width=8, height=8, spp=1, **kw, device="cpu")
    return scene, cam, RenderConfig(shadow_mode="binary", max_depth=depth, use_pallas=True)


def test_dense_scene_grads_through_render_hdr_match_jax(jax_grads, monkeypatch):
    """partition -> combine -> render_hdr on mixed_dense_scene (619
    primitives, max_depth 2, whole-frame chunk): the culled forward and the
    dense adjoint (plain versions on the CPU), every float leaf against
    jax.grad of integrate_chain."""
    _, _, img_ref, ref, _, _ = jax_grads("mixed")
    scene, cam, cfg = port_scene("mixed")
    calls = []
    monkeypatch.setattr(cg, "chain_grad_dense_plain", spy(cg.chain_grad_dense_plain, calls))
    params, static = partition(scene)
    img = render_hdr(combine(params, static), cam, cfg)
    loss = (img * img).sum()
    loss.backward()
    assert len(calls) == 1 and calls[0].culled
    np.testing.assert_allclose(float(loss.detach()), float((img_ref.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = leaf_errors(ours, ref)
    assert not errors, errors
    for k in ("triangles.v0", "spheres.centers", "planes.normals", "lights.positions",
              "triangles.materials.color"):
        assert np.abs(ours[k]).max() > 0, k


@pytest.mark.parametrize("name", sorted(GRAD_SCENES))
def test_dense_ray_grads_through_render_rays_match_jax(jax_grads, name):
    """render_rays with o, d requiring grad: the ray cotangents of the dense
    adjoint against jax.grad (origins, and directions on their tangential
    part); the scene leaves too on the dense mesh (no spheres)."""
    o_np, d_np, img_ref, ref, go_ref, gd_ref = jax_grads(name)
    scene, _, cfg = port_scene(name)
    params, static = partition(scene)
    o = torch.from_numpy(o_np).requires_grad_(True)
    d = torch.from_numpy(d_np).requires_grad_(True)
    img = render_rays(combine(params, static), o, d, cfg)
    (img * img).sum().backward()
    ok, err, bound = origin_cot_ok(o.grad.numpy(), go_ref)
    assert ok, (err, bound)
    ok, p99, mx, scale = direction_cot_ok(d.grad.numpy(), gd_ref, d_np)
    assert ok, (p99, mx, scale)
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = leaf_errors(ours, ref)
    assert not errors, errors


def spy(fn, calls):
    def wrapped(tables, *a, **k):
        calls.append(tables)
        return fn(tables, *a, **k)
    return wrapped


@pytest.mark.parametrize("case", ["spheres", "culled_mesh", "many_spheres"])
def test_adjoint_routing(monkeypatch, case):
    """With spies: at most 128 triangles and 512 primitives -> chain_grad
    (tables not culled); a culled scene -> chain_grad_dense; more than 512
    primitives without culling (spheres) -> chain_grad_dense on plain
    tables. Each scene's gradients equal autograd of integrate_chain."""
    calls = {"chain_grad": [], "chain_grad_dense": []}
    monkeypatch.setattr(cg, "chain_grad_plain", spy(cg.chain_grad_plain, calls["chain_grad"]))
    monkeypatch.setattr(cg, "chain_grad_dense_plain", spy(cg.chain_grad_dense_plain, calls["chain_grad_dense"]))
    if case == "spheres":
        scene, cam = builders.baseline_sphere_scene(6, 6, n_lights=2, device="cpu")
    elif case == "culled_mesh":
        scene, cam = builders.dense_mesh_scene(6, 6, ni=8, nj=24, device="cpu")
    else:
        from raytracingengine_tpu_torch.geometry.materials import Material
        from raytracingengine_tpu_torch.scene import SceneBuilder

        b = SceneBuilder()
        for i in range(cg.MAX_PRIMS + 1):
            b.add_sphere((float(i % 23) - 11.0, float(i // 23) - 11.0, 12.0), 0.4,
                         Material(color=(0.5, 0.5, 0.5), specular=0.2))
        b.add_light((0.0, 0.0, -5.0), (1.0, 1.0, 1.0), 50.0)
        scene = b.build(device="cpu")
        _, cam = builders.baseline_sphere_scene(3, 3, spp=1, device="cpu")
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, max_depth=2)
    params, static = partition(scene)
    (render_hdr(combine(params, static), cam, cfg) ** 2).sum().backward()
    want = "chain_grad" if case == "spheres" else "chain_grad_dense"
    assert {k: len(v) for k, v in calls.items()} == {
        k: int(k == want) for k in calls}, calls
    assert calls[want][0].culled == (case == "culled_mesh")
    ours = {k: p.grad for k, p in params.items()}
    params2, static2 = partition(scene)
    img = render_hdr(combine(params2, static2), cam, dataclasses.replace(cfg, use_pallas=False))
    (img**2).sum().backward()
    ref = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for k, p in params2.items()}
    ours = {k: np.zeros(ref[k].shape, np.float32) if g is None else g.numpy() for k, g in ours.items()}
    assert not leaf_errors(ours, ref)


def sphere_grid(pkg_builder, pkg_material, n, **build_kw):
    """n small spheres on a grid 12 units away, and one light: past the
    dense adjoint's shared memory from n = 5,282."""
    b = pkg_builder()
    for i in range(n):
        b.add_sphere((0.5 * (i % 73) - 18.0, 0.5 * (i // 73) - 18.0, 12.0), 0.2,
                     pkg_material(color=(0.2 + 0.6 * (i % 7) / 6, 0.5, 0.7), specular=0.2))
    b.add_light((0.0, 2.0, -5.0), (1.0, 1.0, 1.0), 50.0)
    return b.build(**build_kw)


def test_adjoint_ceilings_route_by_counts(monkeypatch):
    """The routing decision by counts, with no ceiling of the JAX package's
    TPU kernels: any culled table, or more than 512 primitives, takes the
    dense adjoint, past 131,072 triangles and 8,192 spheres too. Its sink
    (cg.dense_sink) is "shared" wherever the sphere, plane and light
    cotangents fit one block's shared memory (11 floats per sphere or
    plane, 7 per light: 5,281 spheres, no plane and one light fit) and
    "global" for every count past that, so the rule is monotone. Past it,
    on 5,282 spheres, 3x3 rays and one bounce (the plain scans step through
    the primitives one by one), render_hdr's gradient (the plain dense
    adjoint) matches jax.grad of JAX integrate_chain leaf by leaf
    (parity.grad_leaf_mismatches). Culled tables refuse more primitives
    than float32 row 12 indexes exactly."""
    def tables(ns=0, np_=0, nt=0, culled=False, nl=1):
        cols = lambda n: max(n, 1)  # noqa: E731 (pack_scene_tables' empty families)
        return ct.SceneTables(torch.zeros((4, cols(ns))), torch.zeros((4, cols(np_))),
                              torch.zeros((13 if culled else 12, cols(nt))),
                              torch.zeros((7, cols(ns + np_ + nt))), torch.zeros((7, nl)),
                              ns, np_, nt, nl, taabb=torch.zeros((6, 9)) if culled else None)

    route = cg.adjoint_route
    assert route(tables(nt=12)) == "chain_grad"
    assert route(tables(ns=5, np_=6, nt=501)) == "chain_grad"
    assert route(tables(ns=5, np_=6, nt=502)) == "chain_grad_dense"
    assert route(tables(nt=129, culled=True)) == "chain_grad_dense"
    assert route(tables(ns=8_193)) == "chain_grad_dense"
    for fits in (tables(np_=1, nt=131_073, culled=True), tables(ns=5_281)):
        assert route(fits) == "chain_grad_dense"
        assert cg.dense_sink(fits) == "shared"
    for ns, np_, nl in ((5_282, 0, 1), (5_281, 0, 3), (2_700, 2_600, 1), (8_192, 0, 1),
                        (8_193, 0, 1), (20_000, 1, 2)):
        assert cg.dense_sink(tables(ns=ns, np_=np_, nl=nl)) == "global", (ns, np_, nl)
    # the culled scan's staging leaves less room: 5,100 spheres fit only without it
    assert cg.dense_sink(tables(ns=5_100, np_=1, nt=129)) == "shared"
    assert cg.dense_sink(tables(ns=5_100, np_=1, nt=129, culled=True)) == "global"

    n = 5_282
    j_scene, j_cam = sphere_grid(JaxSceneBuilder, JaxMaterial, n), jax_builders.head_box_scene(3, 3, spp=1)[1]
    o, d = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    jcfg = JaxConfig(shadow_mode="binary", max_depth=1)

    def img_and_grads(s):
        img, vjp = jax.vjp(lambda s: jax_integrate_chain(jax_flatten(s), o, d, jcfg), s)
        return img, vjp(2.0 * img)[0]

    img_ref, g_ref = jit_o0(img_and_grads)(j_scene)
    ref = {k: v for k, v in jax_leaves(g_ref).items() if np.issubdtype(v.dtype, np.floating)}
    calls = []
    monkeypatch.setattr(cg, "chain_grad_dense_plain", spy(cg.chain_grad_dense_plain, calls))
    params, static = partition(sphere_grid(SceneBuilder, Material, n, device="cpu"))
    _, cam = builders.head_box_scene(3, 3, spp=1, device="cpu")
    img = render_hdr(combine(params, static), cam, RenderConfig(shadow_mode="binary", use_pallas=True,
                                                                max_depth=1))
    (img * img).sum().backward()
    assert len(calls) == 1 and cg.dense_sink(calls[0]) == "global"
    report = seam_budget(img.detach().numpy().reshape(-1, 3), np.asarray(img_ref))
    assert report.ok, report
    ours = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for k, p in params.items()}
    errors = grad_leaf_mismatches(ours, ref)
    assert not errors, errors
    assert np.abs(ours["spheres.centers"]).max() > 0 and np.abs(ours["spheres.materials.color"]).max() > 0
    scene, _ = builders.dense_mesh_scene(4, 4, ni=8, nj=24, device="cpu")
    flat = flatten_scene(scene)
    monkeypatch.setattr(ct, "MAX_INDEX", flat.n_primitives - 1)
    with pytest.raises(NotImplementedError, match="float32"):
        ct.pack_forward_tables_perm(flat)
    monkeypatch.setattr(ct, "MAX_INDEX", flat.n_primitives)
    assert ct.pack_forward_tables_perm(flat).culled


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def cuda_culled_forward_matches_plain(cuda_device, spp):
    """The culled chain_trace (spp=1) and spp_trace (spp=4) kernels against
    their plain versions on dense_mesh_scene at 64x64, seam budget."""
    scene, cam = builders.dense_mesh_scene(64, 64, spp=spp, device=cuda_device)
    flat = flatten_scene(scene)
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True)
    px, py = cam.pixel_grid()
    if spp == 1:
        o, d = cam.rays_for_pixels(px, py)
        tables = ct.pack_forward_tables_perm(flat, mean_direction(d))
        before = ct.chain_trace.launches
        ours = ct.chain_trace(tables, o.contiguous(), d, cfg)
        assert ct.chain_trace.launches == before + 1
        ref = ct.trace_chain_plain(tables, o, d, cfg)
    else:
        tables = ct.pack_forward_tables_perm(flat)
        before = st.spp_trace.launches
        ours = st.spp_trace(tables, cam, px, py, cfg, seed=9)
        assert st.spp_trace.launches == before + 1
        ref = st.spp_trace_plain(tables, cam, px, py, cfg, seed=9)
    torch.cuda.synchronize()
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(f"spp={spp}: {report}")
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report


def cuda_chain_grad_dense_matches_plain(cuda_device):
    """The dense adjoint kernel on each sink (cg.DENSE_SINKS; dense_sink
    picks "shared" on both scenes, "global" is pinned) against
    chain_grad_dense_plain at 64x64, g = d mean(img^2) / d img: on
    mixed_dense_scene (culled tables) and stress_scene with 40 spheres
    (linear tables, 4 lights in 128 slots); ray cotangents under the seam
    budget, table rows by parity.table_cot_rows."""
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True)
    for make in (lambda: builders.mixed_dense_scene(64, 64, device=cuda_device),
                 lambda: builders.stress_scene(40, width=64, height=64, device=cuda_device)):
        scene, cam = make()
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        o = o.contiguous()
        flat = flatten_scene(scene)
        tables = (ct.pack_forward_tables_perm(flat, mean_direction(d)) if flat.n_triangles
                  else ct.pack_scene_tables(flat))
        assert cg.dense_sink(tables) == "shared"
        img = ct.chain_trace(tables, o, d, cfg)
        g = (2.0 * img / img.numel()).contiguous()
        ref_cots, ref_go, ref_gd = cg.chain_grad_dense_plain(tables, o, d, g, cfg)
        for sink in cg.DENSE_SINKS:
            before = dict(cg.chain_grad_dense.routes)
            cots, go, gd = cg.chain_grad_dense(tables, o, d, g, cfg, sink=sink)
            assert cg.chain_grad_dense.routes == {**before, sink: before[sink] + 1}
            torch.cuda.synchronize()
            for name, ours, ref in (("d_o", go, ref_go), ("d_d", gd, ref_gd)):
                report = ray_cot_seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
                print(f"{sink} {name}: {report}")
                assert np.isfinite(ours.cpu().numpy()).all() and report.ok, (sink, name, report)
            for name, ours, ref in zip(TABLE_ROWS, cots, ref_cots):
                assert ours.shape == ref.shape
                a, b = ours.cpu().numpy(), ref.cpu().numpy()
                if name == "tri" and tables.culled:  # row 12, the original index, carries none
                    assert (a[12] == 0).all()
                    a, b = a[:12], b[:12]
                rows = table_cot_rows(name, a, b)
                print("\n".join(map(str, rows)))
                assert all(r.ok for r in rows), (sink, [str(r) for r in rows if not r.ok])


def cuda_ragged_blocks_match_plain(cuda_device, case):
    """The chain kernels on ray blocks that do not fill their last CTA or
    pixel tile, against their plain versions at 37x29: culled_ragged,
    chain_trace and chain_grad_dense on dense_mesh_scene's rays but the
    last 5 (a CTA's threads without a ray still take part in its votes);
    chunked, render_hdr of dense_mesh_scene in chunks of 300 rays against
    the CPU render; culled_spp8, spp_trace at spp=8; linear_tiles_ragged,
    chain_trace and chain_grad on the head box's rays but the last 5, the
    adjoint with the 32x4 pixel-tile map (width 37: tiles do not divide the
    rows, and the last row is short). Seam budget; the adjoints' ray
    cotangents and table rows as in test_cuda_chain_grad_dense_matches_plain."""
    w, h = 37, 29
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True)
    if case == "chunked":
        cfg = dataclasses.replace(cfg, chunk_size=300)
        ours = render_hdr(*builders.dense_mesh_scene(w, h, device=cuda_device), cfg)
        ref = render_hdr(*builders.dense_mesh_scene(w, h, device="cpu"), cfg)
        report = seam_budget(ours.cpu().numpy(), ref.numpy())
        print(report)
        assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
        return
    spp = 8 if case == "culled_spp8" else 1
    build = builders.head_box_scene if case == "linear_tiles_ragged" else builders.dense_mesh_scene
    scene, cam = build(w, h, spp=spp, device=cuda_device)
    flat = flatten_scene(scene)
    px, py = cam.pixel_grid()
    if spp == 8:
        tables = ct.pack_forward_tables_perm(flat)
        ours = st.spp_trace(tables, cam, px, py, cfg, seed=3)
        ref = st.spp_trace_plain(tables, cam, px, py, cfg, seed=3)
    else:
        r = w * h - 5
        o, d = (x[:r].contiguous() for x in cam.rays_for_pixels(px, py))
        if case == "linear_tiles_ragged":
            tables = ct.pack_scene_tables(flat)
            assert not tables.culled
        else:
            tables = ct.pack_forward_tables_perm(flat, mean_direction(d))
        ours = ct.chain_trace(tables, o, d, cfg)
        ref = ct.trace_chain_plain(tables, o, d, cfg)
    torch.cuda.synchronize()
    report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
    print(report)
    assert np.isfinite(ours.cpu().numpy()).all() and report.ok, report
    if spp == 8:
        return
    g = (2.0 * ours / ours.numel()).contiguous()
    if case == "linear_tiles_ragged":
        before = cg.chain_grad.launches
        _, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
        cots, go, gd = cg.chain_grad(tables, o, d, g, cfg, width=w, tape=tape)
        assert cg.chain_grad.launches == before + 1
        ref_cots, ref_go, ref_gd = cg.chain_grad_plain(tables, o, d, g, cfg)
    else:
        cots, go, gd = cg.chain_grad_dense(tables, o, d, g, cfg)
        ref_cots, ref_go, ref_gd = cg.chain_grad_dense_plain(tables, o, d, g, cfg)
    torch.cuda.synchronize()
    for name, a, b in (("d_o", go, ref_go), ("d_d", gd, ref_gd)):
        report = ray_cot_seam_budget(a.cpu().numpy(), b.cpu().numpy())
        print(f"{name}: {report}")
        assert np.isfinite(a.cpu().numpy()).all() and report.ok, (name, report)
    for name, a, b in zip(TABLE_ROWS, cots, ref_cots):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name == "tri" and tables.culled:
            assert (a[12] == 0).all()
            a, b = a[:12], b[:12]
        rows = table_cot_rows(name, a, b)
        assert all(r.ok for r in rows), [str(r) for r in rows if not r.ok]


@pytest.mark.gpu
def test_cuda_dense_kernels_match_plain(cuda_device):
    """Every check of this file on the card, one after another: one test item,
    since off the card it skips (chip_smoke.py covers each on the main paths' shapes)."""
    for spp in (1, 4):
        cuda_culled_forward_matches_plain(cuda_device, spp)
    cuda_chain_grad_dense_matches_plain(cuda_device)
    for case in ('culled_ragged', 'chunked', 'culled_spp8', 'linear_tiles_ragged'):
        cuda_ragged_blocks_match_plain(cuda_device, case)
