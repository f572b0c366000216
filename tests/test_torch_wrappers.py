"""PyTorch port, kernel wrappers and routing.

(h) A CPU tensor reaches the plain version and leaves the launch counter
unchanged; unsupported configurations raise NotImplementedError; bad
inputs raise. The tests marked `gpu` need a CUDA card: they launch the
kernels against their plain versions and check that a CUDA input with
requires_grad raises. They skip on a host without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytracingengine_tpu_torch.kernels.chain_trace as ct
import raytracingengine_tpu_torch.kernels.spp_trace as st
import raytracingengine_tpu_torch.render.pipeline as pipeline
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)


def small_head_box(spp=1, device="cpu"):
    scene, cam = builders.head_box_scene(width=8, height=6, spp=spp, device=device)
    return scene, cam, ct.pack_scene_tables(flatten_scene(scene))


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


UNSUPPORTED = {
    "wavefront": dict(mode="wavefront"),
    "march": dict(shadow_mode="march"),
    "soft": dict(shadow_mode="soft"),
    "soft_primary": dict(soft_primary=True),
    "differentiable": dict(differentiable=True),
    "no_kernels": dict(use_pallas=False),
    "defaults": None,
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_configs_raise(name):
    cfg = RenderConfig() if UNSUPPORTED[name] is None else dataclasses.replace(
        CFG, **UNSUPPORTED[name]
    )
    scene, cam, _ = small_head_box()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pipeline.render_hdr(scene, cam, cfg)
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
