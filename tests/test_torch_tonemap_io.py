"""PyTorch port, tonemapping and image I/O against the JAX package.

(g) All 7 operators on seeded HDR input with values above 1 and exact
zeros (rtol 1e-6), `to_uint8` exactly, the PPM/PNG writers byte for byte
against raytracingengine_tpu.imageio's Python writers, on every backend
(python, native, auto) the same PPM bytes and PNG pixels, and the
reference dumps' helpers (dump_path, have_dump, load_dump) against
golden/refdump.py's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.golden import refdump
from raytracingengine_tpu.imageio import png as jax_png
from raytracingengine_tpu.imageio import ppm as jax_ppm
from raytracingengine_tpu.tonemap import OPERATORS as JAX_OPERATORS
from raytracingengine_tpu.tonemap import to_uint8 as jax_to_uint8
from raytracingengine_tpu_torch.imageio import (
    dump_path,
    have_dump,
    load_dump,
    png_bytes,
    ppm_bytes,
    read_hdr64,
    read_png,
    read_ppm,
    write_png,
    write_ppm,
)
from raytracingengine_tpu_torch.tonemap import OPERATORS, to_uint8, tonemap, tonemap_all

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_hdr(luminance_safe: bool) -> np.ndarray:
    rng = np.random.default_rng(3)
    hdr = rng.gamma(1.0, 0.8, (17, 13, 3)).astype(np.float32)  # many > 1
    hdr[0, :4] = [4.0, 9.5, 30.0]
    if not luminance_safe:
        hdr[1, 1] = 0.0  # exact zeros
        hdr[2, 2] = [0.0, 0.5, 0.0]
    return hdr


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operator_matches_jax(op):
    # Luminance-space operators divide by the input luminance with no zero
    # guard (as the reference), so a black pixel is non-finite in both.
    hdr = seeded_hdr(luminance_safe="luminance" in op or op == "reinhard_jodie")
    ours = OPERATORS[op](torch.from_numpy(hdr)).numpy()
    ref = np.asarray(JAX_OPERATORS[op](jnp.asarray(hdr)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        to_uint8(torch.from_numpy(ours)).numpy(), np.asarray(jax_to_uint8(jnp.asarray(ours)))
    )


def test_tonemap_entry_points():
    hdr = torch.from_numpy(seeded_hdr(luminance_safe=True))
    assert sorted(tonemap_all(hdr)) == sorted(OPERATORS)
    torch.testing.assert_close(tonemap(hdr), OPERATORS["aces"](hdr), rtol=0, atol=0)


def test_to_uint8_truncates_and_clamps():
    x = torch.tensor([-1.0, 0.0, 0.5, 254.9 / 255.0, 1.0, 7.0, 1.0 / 255.0 - 1e-7])
    assert to_uint8(x).tolist() == [0, 0, 127, 254, 255, 255, 0]
    grid = np.linspace(-0.1, 1.1, 4001, dtype=np.float32)
    np.testing.assert_array_equal(
        to_uint8(torch.from_numpy(grid)).numpy(), np.asarray(jax_to_uint8(jnp.asarray(grid)))
    )


def test_ppm_and_png_bytes_match_jax(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (9, 14, 3), dtype=np.uint8)
    assert ppm_bytes(img) == jax_ppm.ppm_bytes(img)
    assert png_bytes(img, backend="python") == jax_png.png_bytes(img, backend="python")
    jax_ppm.write_ppm(str(tmp_path / "b.ppm"), img, backend="python")
    for backend in ("python", "native", "auto"):
        write_ppm(str(tmp_path / "a.ppm"), img, backend=backend)
        assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes() == ppm_bytes(img), backend
        np.testing.assert_array_equal(read_ppm(str(tmp_path / "a.ppm")), img)
        # the native PNG: the same pixels (zlib builds may compress differently)
        write_png(str(tmp_path / "a.png"), img, backend=backend)
        assert (tmp_path / "a.png").read_bytes() == png_bytes(img, backend=backend), backend
        np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
        np.testing.assert_array_equal(jax_png.read_png(str(tmp_path / "a.png")), img)
        with pytest.raises(ValueError):
            write_ppm(str(tmp_path / "c.ppm"), img.astype(np.float32), backend=backend)
        with pytest.raises(ValueError):
            png_bytes(img.astype(np.float32), backend=backend)
    native = png_bytes(img, compress_level=9, backend="native")
    (tmp_path / "n.png").write_bytes(native)
    np.testing.assert_array_equal(read_png(str(tmp_path / "n.png")), img)
    with pytest.raises(ValueError):
        ppm_bytes(img.astype(np.float32))
    with pytest.raises(ValueError, match="backend"):
        write_ppm(str(tmp_path / "c.ppm"), img, backend="bogus")


def test_read_hdr64_matches_jax():
    path = os.path.join(REPO, "refbuild", "baseline_spheres_256.hdr64")
    ours = read_hdr64(path)
    assert ours.shape == (256, 256, 3) and ours.dtype == np.float64
    np.testing.assert_array_equal(ours, refdump.read_hdr64(path))
    assert dump_path("baseline_spheres_256") == refdump.dump_path("baseline_spheres_256") == os.path.abspath(path)
    assert have_dump("baseline_spheres_256") and not have_dump("no_such_dump")
    assert have_dump("no_such_dump") == refdump.have_dump("no_such_dump")
    np.testing.assert_array_equal(load_dump("baseline_spheres_256"), ours)
