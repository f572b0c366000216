"""PyTorch port, whole render path on the CPU against pinned artifacts and
the float64 oracle.

(f) render_hdr -> tonemap -> to_uint8 against goldens/*.ppm at the budget
of tests/test_golden_artifacts.py (seam-tie pixels reproduce a golden
neighbour, > 95% of bytes exact), and the baseline-spheres frame against
the real C++ engine's dump refbuild/baseline_spheres_256.hdr64 at the
budget of tests/test_reference_parity.py (p99.9 HDR diff < 5e-5, no LDR
subpixel more than 1 byte off).

The port's oracle (raytracingengine_tpu_torch/golden/) against the JAX
package's on scenes converted from JAX: equal bit for bit, frames and the
g_* tonemaps; and the port's render_hdr against its own oracle at
tests/test_integrator_golden.py's budget (rtol 2e-3, atol 3e-3: fp32
against fp64 over a 10-deep recursion).
"""

import os

import jax
import numpy as np
import pytest
import torch

from raytracingengine_tpu.golden import reference as jax_golden
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from raytracingengine_tpu_torch.golden import reference as golden

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


def from_jax(tree) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in flat}


#: name -> (JAX builder, max_depth): the head box (chain) and the glass
#: sphere (refraction, TIR, march shadows) of tests/test_integrator_golden.py,
#: rendered here at 10x8 pixels.
ORACLE_SCENES = {"head_box": (jax_builders.head_box_scene, 10), "glass": (jax_builders.glass_sphere_scene, 6)}


@pytest.mark.parametrize("name", sorted(ORACLE_SCENES))
def test_oracle_matches_jax_and_render(name):
    """The scene converted from JAX: the two oracles' frames equal bit for
    bit, and so is every g_* tonemap of them (and g_to_uint8); the port's
    render_hdr (integrators, march shadows) within rtol 2e-3 / atol 3e-3 of
    its oracle."""
    make, depth = ORACLE_SCENES[name]
    j_scene, j_cam = make(width=10, height=8, spp=1)
    scene = scene_from_numpy(from_jax(j_scene), has_transparency=j_scene.has_transparency, device="cpu")
    cam = camera_from_numpy(from_jax(j_cam), width=10, height=8, spp=1, device="cpu")
    ref = jax_golden.golden_from_scene(j_scene, j_cam, max_depth=depth).render()
    ours = golden.golden_from_scene(scene, cam, max_depth=depth).render()
    np.testing.assert_array_equal(ours, ref)
    for op, fn in golden.GOLDEN_OPERATORS.items():
        np.testing.assert_array_equal(fn(ours), jax_golden.GOLDEN_OPERATORS[op](ref), err_msg=op)
        np.testing.assert_array_equal(golden.g_to_uint8(fn(ours)), jax_golden.g_to_uint8(fn(ref)))
    img = render_hdr(scene, cam, RenderConfig(max_depth=depth)).numpy().astype(np.float64)
    np.testing.assert_allclose(img, ours, rtol=2e-3, atol=3e-3)
