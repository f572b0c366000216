"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ../csrc are compiled at first use into one shared library
with a plain C interface. Each source is compiled by its own nvcc, all
started together, and one more links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> <source>   (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

No fast-math flags: the kernels are fp32 with IEEE division and square
root, like the reference. The library goes to build/raytracingengine_tpu_torch/
at the repository root, named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the previous build. Every C
entry point returns cudaGetLastError() after its launch; `check` raises
if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "chain_trace.cu", "spp_trace.cu", "chain_grad.cu", "chain_grad_dense.cu",
    "wavefront_trace.cu", "wavefront_spp_trace.cu", "wavefront_grad.cu",
)
HEADERS = ("trace_common.cuh", "adjoint_common.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytracingengine_tpu_torch"

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
#: Per table: pointer, column count, primitive count (light: pointer,
#: columns, count; mat: pointer, columns).
_TABLE_ARGTYPES = [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I]
#: The culling boxes and the block count (`culling_args`).
_CULL_ARGTYPES = [_P, _I]
_TRACE_ARGTYPES = [_I, _F, _F, _P]  # max_depth, bias, min_weight, stream
#: max_depth, bias, min_weight, march, shadow_max_steps, shadow_min_t,
#: budget, dropped-push counter (the stream follows, after any other
#: argument of the entry point)
_WAVEFRONT_ARGTYPES = [_I, _F, _F, _I, _I, _F, _I, _P]


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librte_trace-{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every nvcc -> their joined output; raise if one failed."""
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet -> (path, compiler log).

    The log holds ptxas' register and spill report; it is empty when the
    library was already built."""
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
        log = _run([
            _start([nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / s)])
            for s, obj in zip(SOURCES, objs)
        ])
        lib = os.path.join(tmp, out.name)
        log += _run([_start([nvcc(), *ARCH_FLAGS, "-shared", "-o", lib, *objs])])
        os.replace(lib, out)
    return out, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    # o, d, out, n_rays, route (out: the scan taken, kernels/chain_trace.py::
    # ROUTES), tape (null: the kernels without the tape)
    lib.rte_chain_trace.argtypes = (
        _TABLE_ARGTYPES + _CULL_ARGTYPES + [_P, _P, _P, _I, _IP, _P] + _TRACE_ARGTYPES
    )
    lib.rte_chain_trace.restype = _I
    # out (device int32 [4]: the live extents), route (out), stream
    lib.rte_stage_extents.argtypes = _TABLE_ARGTYPES + [_P, _IP, _P]
    lib.rte_stage_extents.restype = _I
    # cam, px, py, out, n_pixels, width, height, spp, seed, route (out)
    lib.rte_spp_trace.argtypes = (
        _TABLE_ARGTYPES + _CULL_ARGTYPES
        + [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _IP] + _TRACE_ARGTYPES
    )
    lib.rte_spp_trace.restype = _I
    # tape, g, d_o, d_d, n_rays, width (the thread-to-ray map's), partials,
    # total, n_ctas, route (out: the shadow scan taken)
    lib.rte_chain_grad.argtypes = (
        _TABLE_ARGTYPES + [_P, _P, _P, _P, _I, _I, _P, _I, _I, _IP] + _TRACE_ARGTYPES
    )
    lib.rte_chain_grad.restype = _I
    # o, d, g, d_o, d_d, n_rays, states, partials, total, gtri, gmat, gsp
    # (null on the shared sink), sink (kernels/chain_grad.py::DENSE_SINKS)
    lib.rte_chain_grad_dense.argtypes = (
        _TABLE_ARGTYPES + _CULL_ARGTYPES + [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I]
        + _TRACE_ARGTYPES
    )
    lib.rte_chain_grad_dense.restype = _I
    # CTAs per SM of each kernel (the trace kernels: by route code,
    # kernels/chain_trace.py::ROUTES, and chain_trace taping or not;
    # chain_grad: by route code and dynamic shared bytes; chain_grad_dense:
    # culled or not, dynamic shared bytes, global sink or not; wavefront_trace:
    # counting or not, culled or not; wavefront_spp_trace: culled or not)
    for name, args in (("rte_chain_trace_occupancy", [_I, _I]), ("rte_spp_trace_occupancy", [_I]),
                       ("rte_chain_grad_occupancy", [_I, _I]),
                       ("rte_chain_grad_dense_occupancy", [_I, _I, _I]),
                       ("rte_wavefront_trace_occupancy", [_I, _I]),
                       ("rte_wavefront_spp_trace_occupancy", [_I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = _I
    # The tapes' sizes in floats: the chain tape's (max_depth, n_rays), the
    # glass adjoint's (its slots of 32 nodes)
    lib.rte_chain_tape_floats.argtypes = [_I, _I]
    lib.rte_chain_tape_floats.restype = _LL
    lib.rte_wavefront_tape_floats.argtypes = [_LL]
    lib.rte_wavefront_tape_floats.restype = _LL
    # o, d, out, n_rays, ..., warp_pops (null: the kernel without the counts)
    lib.rte_wavefront_trace.argtypes = (
        _TABLE_ARGTYPES + _CULL_ARGTYPES + [_P, _P, _P, _I] + _WAVEFRONT_ARGTYPES + [_P, _P]
    )
    lib.rte_wavefront_trace.restype = _I
    lib.rte_wavefront_spp_trace.argtypes = (
        _TABLE_ARGTYPES + _CULL_ARGTYPES + [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32]
        + _WAVEFRONT_ARGTYPES + [_P]
    )
    lib.rte_wavefront_spp_trace.restype = _I
    # o, d, g, d_o, d_d, n_rays, warp_pops, starts, tape, n_slots, overruns,
    # partials, out, total
    lib.rte_wavefront_grad.argtypes = (
        _TABLE_ARGTYPES + [_P, _P, _P, _P, _P, _I, _P, _P, _P, _LL, _P, _P, _P, _I]
        + _WAVEFRONT_ARGTYPES + [_P]
    )
    lib.rte_wavefront_grad.restype = _I
    lib.rte_chain_grad_reduce.argtypes = [_P, _I, _I, _P, _P]
    lib.rte_chain_grad_reduce.restype = _I
    lib.rte_error_string.argtypes = [_I]
    lib.rte_error_string.restype = ctypes.c_char_p
    return lib


def table_args(tables) -> list:
    """The C calling convention of a SceneTables (see csrc/trace_common.cuh)."""
    return [
        tables.sph.data_ptr(), tables.sph.shape[1], tables.n_spheres,
        tables.pl.data_ptr(), tables.pl.shape[1], tables.n_planes,
        tables.tri.data_ptr(), tables.tri.shape[1], tables.n_triangles,
        tables.mat.data_ptr(), tables.mat.shape[1],
        tables.light.data_ptr(), tables.light.shape[1], tables.n_lights,
    ]


def culling_args(tables) -> list:
    """The culling boxes' pointer and the block count of a SceneTables:
    null and 0 for tables that are not culled (csrc/trace_common.cuh)."""
    return [tables.taabb.data_ptr() if tables.culled else None, tables.n_blocks]


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.rte_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
