"""PyTorch port, whole render path on the CPU against pinned artifacts.

(f) render_hdr -> tonemap -> to_uint8 against goldens/*.ppm at the budget
of tests/test_golden_artifacts.py (seam-tie pixels reproduce a golden
neighbour, > 95% of bytes exact), and the baseline-spheres frame against
the real C++ engine's dump refbuild/baseline_spheres_256.hdr64 at the
budget of tests/test_reference_parity.py (p99.9 HDR diff < 5e-5, no LDR
subpixel more than 1 byte off).
"""

import os

import numpy as np
import pytest
import torch

from raytracingengine_tpu_torch.imageio import read_hdr64, read_ppm
from raytracingengine_tpu_torch.parity import golden_ldr_mismatches, reference_frame_stats
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders
from raytracingengine_tpu_torch.tonemap import OPERATORS, to_uint8

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(shadow_mode="binary", use_pallas=True)
SIZE = 128

SCENES = {
    "head_box": lambda: builders.head_box_scene(width=SIZE, height=SIZE, spp=1, device="cpu"),
    "baseline_spheres": lambda: builders.baseline_sphere_scene(
        width=SIZE, height=SIZE, spp=1, n_lights=2, device="cpu"
    ),
}


@pytest.fixture(scope="module")
def hdr_frames():
    return {name: render_hdr(*make(), CFG) for name, make in SCENES.items()}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("op", ["aces", "simple"])
def test_render_matches_pinned_golden(hdr_frames, scene_name, op):
    gold = read_ppm(os.path.join(REPO, "goldens", f"{scene_name}_{SIZE}_{op}.ppm"))
    hdr = hdr_frames[scene_name]
    assert hdr.shape == (SIZE, SIZE, 3) and torch.isfinite(hdr).all()
    ours = to_uint8(OPERATORS[op](hdr)).numpy()
    errors = golden_ldr_mismatches(ours, gold)
    n_seam = int((np.abs(ours.astype(int) - gold.astype(int)).max(axis=2) > 1).sum())
    print(f"{scene_name}/{op}: {n_seam} seam-tie pixels beyond 1 LDR step")
    assert not errors, errors


def test_baseline_spheres_vs_real_engine():
    ref = read_hdr64(os.path.join(REPO, "refbuild", "baseline_spheres_256.hdr64"))
    scene, cam = builders.baseline_sphere_scene(256, 256, spp=1, device="cpu")
    img = render_hdr(scene, cam, CFG).numpy()
    p999, bad_frac = reference_frame_stats(img, ref)
    print(f"baseline_spheres_256: p99.9 HDR diff {p999:.2e}, bad LDR subpixels {bad_frac:.2e}")
    assert p999 < 5e-5
    assert bad_frac == 0.0
