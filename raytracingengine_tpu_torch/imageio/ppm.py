"""Binary PPM (P6) writer/reader, numpy only.

Byte-compatible with the reference writer (Image.cpp:11-31): header
"P6\\n{W} {H}\\n255\\n" followed by raw RGB byte triples in row-major
order. `write_ppm` writes through native_bridge.py's C++ writer where
`backend` asks for it or ('auto') where it builds: the same bytes.
"""

from __future__ import annotations

import numpy as np

from raytracingengine_tpu_torch import native_bridge


def ppm_bytes(rgb_u8: np.ndarray) -> bytes:
    """rgb_u8: [H, W, 3] uint8 -> the P6 file's bytes."""
    arr = np.asarray(rgb_u8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode("ascii") + arr.tobytes()


def write_ppm(path: str, rgb_u8: np.ndarray, backend: str = "auto") -> None:
    """`backend`: 'native', 'python' or 'auto' (native_bridge.use)."""
    if native_bridge.use(backend):
        native_bridge.write_ppm_native(path, rgb_u8)
        return
    data = ppm_bytes(rgb_u8)
    with open(path, "wb") as f:
        f.write(data)


def read_ppm(path: str) -> np.ndarray:
    """-> [H, W, 3] uint8. Header parsing tolerates whitespace and '#'
    comments, as the format allows."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError("not a binary P6 PPM")
    # Tokenize header: magic, width, height, maxval; then a single
    # whitespace byte precedes the raster.
    pos = 2
    fields: list[int] = []
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # the single whitespace after maxval
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    raster = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
    return raster.reshape(h, w, 3).copy()
