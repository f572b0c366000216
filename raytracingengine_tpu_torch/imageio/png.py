"""Minimal PNG encoder/decoder (8-bit RGB, zlib from the standard library).

The reference shells out to ffmpeg to convert its PPMs to PNG
(RaytracingEngine.cpp:317-318); PNG is encoded directly here: a valid RGB8
PNG with filter 0 on every scanline and a single IDAT chunk, in Python or
through native_bridge.py's C++ encoder where `backend` asks for it or
('auto') where it builds: the same pixels (zlib builds may compress
differently).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracingengine_tpu_torch import native_bridge


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(rgb_u8: np.ndarray, compress_level: int = 6, backend: str = "auto") -> bytes:
    """`backend`: 'native', 'python' or 'auto' (native_bridge.use)."""
    arr = np.asarray(rgb_u8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    if native_bridge.use(backend):
        return native_bridge.png_bytes_native(arr, compress_level)
    h, w = arr.shape[:2]
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) per scanline
    raw[:, 1:] = arr.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, color type 2
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, rgb_u8: np.ndarray, compress_level: int = 6, backend: str = "auto") -> None:
    data = png_bytes(rgb_u8, compress_level, backend)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Decoder for RGB8 PNGs with filters 0-4 -> [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    out = np.zeros((h, w * 3), np.int32)
    bpp = 3  # bytes per pixel
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y > 0 else np.zeros(w * 3, np.int32)
        if ftype == 0:
            out[y] = line
        elif ftype == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth need a scan
            cur = np.zeros(w * 3, np.int32)
            for i in range(w * 3):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
            out[y] = cur
        else:
            raise ValueError(f"unsupported filter {ftype}")
    return out.astype(np.uint8).reshape(h, w, 3)
