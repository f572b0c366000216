"""The chain kernels' thread-to-ray map and the culled scans' block counts,
on the CPU.

`kernels/chain_trace.py::thread_rays` mirrors the kernels' maps
(csrc/trace_common.cuh::ray_of_thread, the identity; csrc/chain_grad.cu::
ray_of_tile_thread, CTAs of 32x4 pixels, a row of 32 per warp, where the
ray block's image width is given): it must take every ray exactly once,
and be the identity for width 0. `roofline.chain_work` counts the blocks a culled scan
tests per lane (the oracle's segments and the kernels' own traversal) and
per warp (the union of its lanes' blocks); the counts are exact integers,
so the tests compare them exactly.
"""

import numpy as np
import pytest
import torch

import raytracingengine_tpu_torch.kernels.chain_trace as ct
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import mean_direction
from raytracingengine_tpu_torch.roofline import chain_work
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)


@pytest.mark.parametrize("width,height,short", [(16, 8, 0), (37, 11, 0), (37, 11, 5), (512, 3, 7)])
def test_thread_rays_is_a_bijection(width, height, short):
    """Every ray of a width x height block (the last `short` missing) is
    taken by exactly one thread; each warp's rays lie in one row of 32
    pixels and each CTA's in one 32x4 tile; the CTA count is map_ctas."""
    n = width * height - short
    t = ct.thread_rays(n, width)
    assert t.shape[0] == ct.map_ctas(n, width) * ct.CTA_THREADS
    valid = t[t >= 0]
    assert torch.equal(torch.sort(valid).values, torch.arange(n))
    for size, (tw, th) in ((32, (ct.CTA_TILE[0], 1)), (ct.CTA_THREADS, ct.CTA_TILE)):
        for g, ok in zip(t.view(-1, size), (t >= 0).view(-1, size)):
            if ok.any():
                xs, ys = (g[ok] % width), (g[ok] // width)
                assert int(xs.max() - xs.min()) < tw and int(ys.max() - ys.min()) < th
                assert int(xs.min()) % tw == 0 and int(ys.min()) % th == 0


@pytest.mark.parametrize("n", [1, 128, 300])
def test_thread_rays_width_zero_is_identity(n):
    t = ct.thread_rays(n, 0)
    assert t.shape[0] == ct.map_ctas(n, 0) * ct.CTA_THREADS
    assert torch.equal(t[:n], torch.arange(n)) and bool((t[n:] == -1).all())


def _mesh_rays(size=8):
    """Camera rays of an 8x8 dense_mesh_scene with 352 triangles (3 culling
    blocks, padded to one group) and its culled tables."""
    scene, cam = builders.dense_mesh_scene(size, size, ni=12, nj=16, device="cpu")
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    tables = ct.pack_forward_tables_perm(flatten_scene(scene), mean_direction(d))
    assert tables.culled and 300 <= tables.n_triangles <= 400
    return tables, o, d


CFG = RenderConfig(shadow_mode="binary", use_pallas=True)


def test_block_counts_union_and_visit_order():
    """The union over a warp's lanes issues at least the tests its lanes
    use, under either map, and a CTA stages at least each of its warps'
    blocks; the kernels' traversal (bound: the running best t) visits at
    least the oracle's blocks in its closest-hit scans."""
    tables, o, d = _mesh_rays()
    w = chain_work(tables, o, d, CFG, widths=(0, 8))
    assert w.lane_blocks > 0 and w.closest_lane_blocks > 0
    for width in (0, 8):
        assert w.warp_blocks[width] >= w.lane_blocks
        assert w.warp_visit_blocks[width] >= w.visit_blocks
        # a CTA stages the union of its four warps' blocks
        assert 4 * 32 * w.staged_blocks[width] >= w.warp_visit_blocks[width] >= 32 * w.staged_blocks[width]
    assert w.closest_visit_blocks >= w.closest_lane_blocks


def test_block_counts_equal_when_a_warp_traces_one_ray():
    """Two warps, each 32 copies of one ray (one that meets the mesh and
    reflects, one that meets the floor in the mesh's shadow, both with
    culled shadow scans): the union equals the per-lane count."""
    tables, o, d = _mesh_rays()
    pick = torch.tensor([37, 44]).repeat_interleave(32)
    w = chain_work(tables, o[pick], d[pick], CFG, widths=(0,))
    assert w.closest_lane_blocks > 0 and w.lane_blocks > w.closest_lane_blocks
    assert w.warp_blocks[0] == w.lane_blocks and w.warp_visit_blocks[0] == w.visit_blocks
