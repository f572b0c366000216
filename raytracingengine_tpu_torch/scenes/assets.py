"""Procedural mesh assets.

The reference loads `box.obj`, which is absent from its repo
(RaytracingEngine.cpp:250). A procedural axis-aligned cube with the same
mesh plumbing (flat vertex list + flat index list, like Model's storage,
Shape.h:251-252) takes its place.
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
