"""PyTorch port, in-kernel AA: the plain version of the spp kernel and its
counter-based jitter.

(d) With the jitter passed in, the AA mean is the JAX mean over samples of
Camera.rays_for_pixels(px, py, jitter) -> integrate_chain, under the seam
budget (elementwise HDR atol 1e-4 except max(4, 1e-3 * pixels) seam-tie
pixels). (e) With its own Philox jitter, a render is statistically the
JAX render (the same check as tests/test_spp_kernel.py), and the
generator is deterministic per seed, in [0, 1), with sample 0 unjittered.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.geometry.intersect import flatten_scene as jax_flatten
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.integrator import integrate_chain
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.kernels.spp_trace import (
    philox4x32,
    pixel_jitter,
    spp_trace,
    spp_trace_plain,
)
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)
JAX_CFG = JaxConfig(shadow_mode="binary")


@pytest.mark.parametrize("fn", ["head_box_scene", "baseline_sphere_scene"])
def test_spp_plain_with_given_jitter_matches_jax(fn):
    """(d) spp=4 at 16x16 with one seeded jitter array [spp, R, 2]."""
    spp, size = 4, 16
    scene, cam = getattr(builders, fn)(width=size, height=size, spp=spp, device="cpu")
    r = cam.num_pixels
    jitter = np.random.default_rng(11).random((spp, r, 2), dtype=np.float32)
    jitter[0] = 0.0  # sample 0 is the unjittered center ray
    px, py = cam.pixel_grid()
    ours = spp_trace_plain(
        pack_scene_tables(flatten_scene(scene)), cam, px, py, CFG,
        jitter=torch.from_numpy(jitter),
    ).numpy()

    j_scene, j_cam = getattr(jax_builders, fn)(width=size, height=size, spp=spp)
    j_flat = jax_flatten(j_scene)
    jpx, jpy = j_cam.pixel_grid()

    @jit_o0
    def jax_mean(jit):
        def one(j):
            o, d = j_cam.rays_for_pixels(jpx, jpy, j)
            return integrate_chain(j_flat, o, d, JAX_CFG)

        return jnp.mean(jax.vmap(one)(jit), axis=0)

    ref = np.asarray(jax_mean(jnp.asarray(jitter)))
    report = seam_budget(ours, ref)
    print(f"{fn} spp={spp}: {report}")
    assert np.isfinite(ours).all() and report.ok, report


def test_spp_render_statistically_matches_jax():
    """(e) the port's own jitter at spp=8 vs JAX render_hdr at spp=8: two
    AA estimates of one image, so the same statistical bounds as the JAX
    in-kernel sampler's test against the center render."""
    size = 24
    scene, cam = builders.baseline_sphere_scene(width=size, height=size, spp=8, device="cpu")
    a = render_hdr(scene, cam, CFG, seed=3).numpy()
    b = render_hdr(scene, cam, CFG, seed=3).numpy()
    np.testing.assert_array_equal(a, b)  # deterministic per seed
    c = render_hdr(scene, cam, CFG, seed=4).numpy()
    assert not np.array_equal(a, c)

    j_scene, j_cam = jax_builders.baseline_sphere_scene(width=size, height=size, spp=8)
    ref = np.asarray(jit_o0(lambda s, c: jax_render_hdr(s, c, JAX_CFG, mode="chain"))(j_scene, j_cam))
    diff = np.abs(a - ref).max(axis=-1)
    print(f"spp=8 vs JAX: q70 {np.quantile(diff, 0.7):.3e} mean {diff.mean():.3e}")
    assert np.isfinite(a).all()
    assert np.quantile(diff, 0.7) < 0.05
    assert diff.mean() < 0.12


def test_pixel_jitter_properties():
    """(e) deterministic per (seed, pixel, sample), in [0, 1), sample 0
    zero, decorrelated across samples, seeds and axes, mean ~1/2."""
    pids = torch.arange(4096, dtype=torch.int32)
    assert (pixel_jitter(9, pids, 0) == 0).all()
    j1 = pixel_jitter(9, pids, 1)
    assert j1.dtype == torch.float32 and j1.shape == (4096, 2)
    torch.testing.assert_close(j1, pixel_jitter(9, pids, 1), rtol=0, atol=0)
    assert float(j1.min()) >= 0.0 and float(j1.max()) < 1.0
    assert abs(float(j1.mean()) - 0.5) < 0.02
    assert torch.unique(j1).numel() > 8000
    for other in (pixel_jitter(9, pids, 2), pixel_jitter(10, pids, 1)):
        assert float((other == j1).float().mean()) < 1e-3
    corr = np.corrcoef(j1[:, 0].numpy(), j1[:, 1].numpy())[0, 1]
    assert abs(corr) < 0.05
    # a pixel's jitter does not depend on which other pixels share the call
    np.testing.assert_array_equal(pixel_jitter(9, pids[1000:1010], 3).numpy(),
                                  pixel_jitter(9, pids, 3)[1000:1010].numpy())


def test_philox_known_answer():
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    out = philox4x32((t(0), t(0), t(0), t(0)), (0, 0))
    assert [int(x) for x in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    out = philox4x32(
        (t(0x243F6A88), t(0x85A308D3), t(0x13198A2E), t(0x03707344)),
        (0xA4093822, 0x299F31D0),
    )
    assert [int(x) for x in out] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_spp_render_is_chunking_independent():
    """The jitter is keyed on the pixel id, so chunking changes nothing."""
    scene, cam = builders.head_box_scene(width=20, height=12, spp=3, device="cpu")
    whole = render_hdr(scene, cam, CFG, seed=5).numpy()
    chunked = render_hdr(scene, cam, dataclasses.replace(CFG, chunk_size=37), seed=5).numpy()
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-6)


def test_spp_wrapper_routes_cpu_to_plain():
    scene, cam = builders.head_box_scene(width=8, height=8, spp=2, device="cpu")
    tables = pack_scene_tables(flatten_scene(scene))
    px, py = cam.pixel_grid()
    before = spp_trace.launches
    out = spp_trace(tables, cam, px, py, CFG, seed=1)
    assert spp_trace.launches == before
    np.testing.assert_array_equal(
        out.numpy(), spp_trace_plain(tables, cam, px, py, CFG, seed=1).numpy()
    )
