"""ctypes bindings to the native C++ OBJ parser and PPM/PNG encoders.

native/src/objparser.cpp (a from-scratch OBJ parser: `v`, every `f` index
form, negative indices, fan triangulation, `usemtl`) and native/src/
imageio.cpp (the P6 writer and an in-process RGB8 PNG encoder on zlib) are
compiled at first use with native/Makefile's flags,

    g++ -O3 -fPIC -std=c++17 -Wall -Wextra -shared -o <lib> <sources> -lz

into build/raytracingengine_tpu_torch/ at the repository root, named by a
hash of the sources and the command, as kernels/_build.py names the CUDA
library. The compiler writes a temporary file that os.replace moves into
place, so processes that build at once do not collide.

The I/O functions choose with `backend`: 'native' requires this library,
'python' never uses it, 'auto' takes it where it builds and otherwise
warns once with the compiler's error and takes the Python path (`use`).
The native paths give the Python paths' arrays and bytes exactly (the PNG:
the same pixels; zlib builds may compress differently).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
NATIVE_SRC = ROOT / "native" / "src"
SOURCES = ("objparser.cpp", "imageio.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
LIBS = ("-lz",)
BUILD_DIR = ROOT / "build" / "raytracingengine_tpu_torch"
BACKENDS = ("auto", "python", "native")

_LIB: ctypes.CDLL | None = None
_ERROR: str | None = None  # the first failed build's message, kept: no rebuild per call
_WARNED = False

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"librte_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet -> its path; raise
    RuntimeError with the compiler's output if that fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH: cannot build {out.name} from {NATIVE_SRC}")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=out.stem, suffix=".tmp")
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(str(NATIVE_SRC / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load (once) the library; raise RuntimeError with
    the build's error where it cannot be had (the same error on every
    later call)."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            _ERROR = f"the native I/O library (native/src) is not available: {e}"
        else:
            _declare(lib)
            _LIB = lib
            return lib
    raise RuntimeError(_ERROR)


def _declare(lib: ctypes.CDLL) -> None:
    lib.rte_obj_parse.restype = _P
    lib.rte_obj_parse.argtypes = [ctypes.c_char_p]
    lib.rte_obj_num_vertices.restype = _I64
    lib.rte_obj_num_vertices.argtypes = [_P]
    lib.rte_obj_num_triangles.restype = _I64
    lib.rte_obj_num_triangles.argtypes = [_P]
    lib.rte_obj_num_materials.restype = _I32
    lib.rte_obj_num_materials.argtypes = [_P]
    lib.rte_obj_error.restype = ctypes.c_char_p
    lib.rte_obj_error.argtypes = [_P]
    lib.rte_obj_material_name.restype = ctypes.c_char_p
    lib.rte_obj_material_name.argtypes = [_P, _I32]
    lib.rte_obj_copy.restype = None
    lib.rte_obj_copy.argtypes = [_P, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_I64),
                                 ctypes.POINTER(_I32)]
    lib.rte_obj_free.restype = None
    lib.rte_obj_free.argtypes = [_P]
    lib.rte_write_ppm.restype = ctypes.c_int
    lib.rte_write_ppm.argtypes = [ctypes.c_char_p, _U8P, _I32, _I32]
    lib.rte_encode_png.restype = _U8P
    lib.rte_encode_png.argtypes = [_U8P, _I32, _I32, _I32, ctypes.POINTER(_I64)]
    lib.rte_free.restype = None
    lib.rte_free.argtypes = [_P]


def available() -> bool:
    """Whether the library is built or builds."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def use(backend: str) -> bool:
    """Whether an I/O function called with `backend` takes the native path:
    'native' -> True, or load()'s RuntimeError; 'python' -> False; 'auto'
    -> whether the library loads, with one warning naming the build's error
    where it does not."""
    global _WARNED
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected 'auto', 'python' or 'native'")
    if backend == "python":
        return False
    if backend == "native":
        load()
        return True
    try:
        load()
    except RuntimeError as e:
        if not _WARNED:
            _WARNED = True
            warnings.warn(f"{e}\nbackend='auto' takes the Python I/O paths", RuntimeWarning, stacklevel=3)
        return False
    return True


def load_obj_native(path: str) -> dict:
    """The native OBJ parse -> imageio.obj.load_obj's dict: vertices [V,3]
    float64, indices [3T] int64, face_materials [T] int32 (-1: none), the
    materials resolved from the mtllib as the Python path resolves them, and
    the usemtl names in first-seen order."""
    from raytracingengine_tpu_torch.imageio.obj import _materials_for

    lib = load()
    h = lib.rte_obj_parse(os.fsencode(path))
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        err = lib.rte_obj_error(h)
        if err:
            raise ValueError(err.decode())
        nv, nt = lib.rte_obj_num_vertices(h), lib.rte_obj_num_triangles(h)
        verts = np.empty((nv, 3), np.float64)
        idx = np.empty(nt * 3, np.int64)
        mats = np.empty(nt, np.int32)
        lib.rte_obj_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         idx.ctypes.data_as(ctypes.POINTER(_I64)), mats.ctypes.data_as(ctypes.POINTER(_I32)))
        names = [lib.rte_obj_material_name(h, i).decode() for i in range(lib.rte_obj_num_materials(h))]
    finally:
        lib.rte_obj_free(h)
    return {
        "vertices": verts,
        "indices": idx,
        "face_materials": mats,
        "materials": _materials_for(path, names),
        "material_names": names,
    }


def _rgb_u8(rgb_u8: np.ndarray) -> np.ndarray:
    """The C side reads H * W * 3 bytes: check the shape and dtype first."""
    arr = np.asarray(rgb_u8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    return np.ascontiguousarray(arr)


def write_ppm_native(path: str, rgb_u8: np.ndarray) -> None:
    """Write rgb_u8 [H, W, 3] uint8 as a binary P6 PPM (imageio/ppm.py's bytes)."""
    arr = _rgb_u8(rgb_u8)
    h, w = arr.shape[:2]
    rc = load().rte_write_ppm(os.fsencode(path), arr.ctypes.data_as(_U8P), w, h)
    if rc != 0:
        raise OSError(f"rte_write_ppm failed ({rc}) writing {path}")


def png_bytes_native(rgb_u8: np.ndarray, compress_level: int = 6) -> bytes:
    """rgb_u8 [H, W, 3] uint8 -> an RGB8 PNG's bytes (filter 0, one IDAT)."""
    arr = _rgb_u8(rgb_u8)
    lib = load()
    h, w = arr.shape[:2]
    out_len = _I64(0)
    ptr = lib.rte_encode_png(arr.ctypes.data_as(_U8P), w, h, compress_level, ctypes.byref(out_len))
    if not ptr:
        raise RuntimeError("rte_encode_png failed")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.rte_free(ptr)
