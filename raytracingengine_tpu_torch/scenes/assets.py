"""Procedural mesh assets.

The reference loads `box.obj`, which is absent from its repo
(RaytracingEngine.cpp:250). A procedural axis-aligned cube with the same
mesh plumbing (flat vertex list + flat index list, like Model's storage,
Shape.h:251-252) takes its place. `bumpy_sphere_mesh` is the dense mesh of
the dense-mesh scenes.
"""

from __future__ import annotations

import numpy as np


def cube_mesh(size: float = 4.0) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned cube centered at the origin, edge length `size`.

    Returns (vertices [8,3] float64, indices [36] int64): 12 triangles
    with outward-facing winding.
    """
    h = size / 2.0
    verts = np.array(
        [
            [-h, -h, -h],
            [h, -h, -h],
            [h, h, -h],
            [-h, h, -h],
            [-h, -h, h],
            [h, -h, h],
            [h, h, h],
            [-h, h, h],
        ],
        dtype=np.float64,
    )
    # Each face as two CCW-from-outside triangles.
    faces = [
        (0, 2, 1), (0, 3, 2),  # -z (front toward camera at -inf)
        (4, 5, 6), (4, 6, 7),  # +z
        (0, 1, 5), (0, 5, 4),  # -y
        (3, 7, 6), (3, 6, 2),  # +y
        (0, 4, 7), (0, 7, 3),  # -x
        (1, 2, 6), (1, 6, 5),  # +x
    ]
    idx = np.array(faces, dtype=np.int64).reshape(-1)
    return verts, idx


def cube_obj_text(size: float = 4.0) -> str:
    """The same cube as Wavefront OBJ text (for the OBJ loader's tests)."""
    verts, idx = cube_mesh(size)
    lines = ["# procedural cube", "o box"]
    for v in verts:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for i in range(0, len(idx), 3):
        lines.append(f"f {idx[i] + 1} {idx[i + 1] + 1} {idx[i + 2] + 1}")
    return "\n".join(lines) + "\n"


def bumpy_sphere_mesh(
    radius: float = 2.0,
    ni: int = 48,
    nj: int = 64,
    amp: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense procedural mesh: a UV-sphere with the radial displacement
    r(theta, phi) = R * (1 + amp * sin(4 theta) * cos(3 phi)).

    ni polar segments x nj azimuthal segments -> nj*(2*ni - 2) triangles
    (a pole quad emits one non-degenerate triangle; the displacement is
    zero at the poles, so each pole ring collapses to one point).
    refbuild/parity_main.cpp builds the same mesh for the C++ engine's
    frames.

    Returns (vertices [(ni+1)*nj, 3] float64, indices [3*k] int64).
    """
    verts = np.empty(((ni + 1) * nj, 3), np.float64)
    for i in range(ni + 1):
        theta = np.pi * i / ni
        st, ct = np.sin(theta), np.cos(theta)
        for j in range(nj):
            phi = 2.0 * np.pi * j / nj
            r = radius * (1.0 + amp * np.sin(4.0 * theta) * np.cos(3.0 * phi))
            verts[i * nj + j] = (
                r * st * np.cos(phi),
                r * ct,
                r * st * np.sin(phi),
            )
    faces = []
    for i in range(ni):
        for j in range(nj):
            j1 = (j + 1) % nj
            a = i * nj + j
            b = (i + 1) * nj + j
            c = (i + 1) * nj + j1
            d = i * nj + j1
            if i > 0:
                faces.append((a, c, d))
            if i < ni - 1:
                faces.append((a, b, c))
    idx = np.asarray(faces, np.int64).reshape(-1)
    return verts, idx
