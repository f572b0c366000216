"""Reader for HDR frames dumped by the real reference engine.

refbuild/parity_main.cpp links the unmodified reference headers, renders
deterministic spp=1 frames and writes raw fp64 HDR as

    b"RTEHDR1\\n"  int32 width  int32 height  width*height*3 float64 (RGB)

row-major with idx = y*width + x (Scene.h:321-324).
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"RTEHDR1\n"

#: The reference build's directory (refbuild/build.sh writes the dumps there).
REFBUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "refbuild")


def read_hdr64(path: str) -> np.ndarray:
    """-> float64 [H, W, 3] HDR image."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 3 * 8), dtype="<f8")
    if data.size != w * h * 3:
        raise ValueError(f"{path}: truncated ({data.size} != {w * h * 3})")
    return data.reshape(h, w, 3)


def dump_path(name: str) -> str:
    return os.path.abspath(os.path.join(REFBUILD_DIR, f"{name}.hdr64"))


def have_dump(name: str) -> bool:
    return os.path.exists(dump_path(name))


def load_dump(name: str) -> np.ndarray:
    """refbuild/<name>.hdr64 -> float64 [H, W, 3]."""
    return read_hdr64(dump_path(name))
