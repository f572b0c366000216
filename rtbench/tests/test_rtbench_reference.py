"""The plain reference against the port's plain path at 16x16 on the CPU,
and its work counts on a hand-built ray set."""

import pytest
import torch

from rtbench.harness import judge, program, registry
from rtbench.reference import whitted as ref

CFG = {"bias": 1e-3, "min_weight": 1e-8, "max_depth": 10}


@pytest.fixture(scope="module")
def bench():
    return registry.load()


@pytest.mark.parametrize("config,spp", [("head_box", 1), ("head_box", 3), ("stress64", 1)])
def test_reference_matches_port_plain(bench, config, spp):
    from raytracingengine_tpu_torch.render.pipeline import render_hdr

    cfg = bench.configs[config]
    conf = registry.load_json(bench.root / cfg["file"], config)
    traffic = {"width": 16, "height": 16, "spp": spp}
    scene = program.build_scene(conf["scene"], conf["program"], "cpu")
    cam = program.build_camera(conf["camera"], 16, 16, spp, "cpu")
    img = render_hdr(scene, cam, program.render_config(conf["program"], traffic), seed=77)
    leaves = ref.scene_leaves(conf["scene"], "cpu")
    r = ref.render(ref.prims(leaves), conf["camera"], 16, 16, spp, 77, judge._settings(conf))
    diff = (img.reshape(-1, 3) - r).abs()
    assert float(diff.max()) < 1e-4 * max(1.0, float(r.abs().max()))


def test_scene_leaves_match_partition(bench):
    from raytracingengine_tpu_torch.inverse import partition

    conf = registry.load_json(bench.root / "rtbench/configs/head_box.json", "head_box")
    params, _ = partition(program.build_scene(conf["scene"], conf["program"], "cpu"))
    leaves = ref.scene_leaves(conf["scene"], "cpu")
    assert set(params) == set(leaves)
    for k, v in params.items():
        assert torch.equal(v.detach(), leaves[k]), k


def _two_spheres():
    m = {"color": [1.0, 1.0, 1.0], "specular": 0.0}
    desc = {"spheres": [{"center": [0, 0, 5], "radius": 1.0, "material": m},
                        {"center": [0, 0, -5], "radius": 1.0, "material": m}],
            "lights": [{"position": [0, 0, -10], "color": [1, 1, 1], "intensity": 10.0}]}
    o = torch.tensor([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, -7]], dtype=torch.float32)
    d = torch.tensor([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0, 1]], dtype=torch.float32)
    return desc, o, d


def test_counts_exact_on_two_spheres():
    """Ray 0 hits sphere A, its shadow ray is blocked by B: 1 test. Ray 1
    hits B facing away from the light: no shadow ray. Ray 2 misses. Ray 3
    hits B's lit side, unoccluded: 2 tests, and the one lit term."""
    desc, o, d = _two_spheres()
    P = ref.prims(ref.scene_leaves(desc, "cpu"))
    c = ref.Counts()
    img = ref.trace(P, o, d, CFG, c)
    assert c.closest == [8, 0, 0]
    assert c.shadow == [3, 0, 0]
    assert c.winners == [3, 0, 0]
    assert c.rays == 4
    assert (c.queries, c.diffuse, c.specular, c.lights) == (4, 1, 0, 1)
    assert c.trace_ops() == 11 * ref.OPS["sphere"]
    assert c.adjoint_ops() == ref.ADJOINT_FACTOR * (
        3 * ref.OPS["sphere"] + 3 * ref.HIT_OPS + ref.SHADE_OPS["diffuse"])
    assert c.record_bytes() == 4 * 4 + (4 + 1) * 3  # ids of 4 queries; t and a bit of 3 hits
    assert float(img[0].abs().sum()) == 0.0  # in shadow, no sky behind a hit
    assert float(img[3].sum()) > 0.0


def test_philox_known_answer_and_port_jitter():
    # Random123's known-answer vector for philox4x32-10 with counter and key
    # all zero: 6627e8d5 e169c58d bc57ac4c 9b00dbd8 (its first two words)
    z = torch.zeros(1, dtype=torch.int64)
    w0, w1 = ref.philox_words(0, z, z)
    assert (int(w0), int(w1)) == (0x6627E8D5, 0xE169C58D)
    from raytracingengine_tpu_torch.kernels.spp_trace import pixel_jitter

    pid = torch.arange(0, 5000, 7)
    for seed, s in ((0, 1), (2**31 + 5, 3), (123456789, 31)):
        assert torch.equal(ref.philox_uniform2(seed, pid, s), pixel_jitter(seed, pid, s))
