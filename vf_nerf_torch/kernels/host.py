"""Build and bind the port's host C++ libraries.

``vf_nerf_torch/csrc/meshops.cpp`` (marching-cubes triangle emission and
vertex dedup), ``csrc/rasterizer.cpp`` (the z-buffer depth rasterizer of
the refuse pass) and ``csrc/jpeg.cpp`` (the datasets' baseline JPEG decoder)
run on the host, as the JAX package's equivalents do. Each is compiled by
``g++ -O3 -shared -fPIC`` at its first use into
``build/host/<source hash>/lib<name>.so`` under the repository root and
loaded with ``ctypes``; nothing is compiled or loaded when this module is
imported. A missing compiler or a failed build raises: the port has no numpy
fallback on these paths (the numpy versions stay as the tests' oracles).
The ``.so`` files that the JAX package builds under the root ``csrc/`` are
never loaded.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("the host libraries of vf_nerf_torch need g++ to "
                           "build; none was found on PATH")
    return found


def _build(src: Path, out_dir: Path, lib_name: str) -> None:
    """Compile ``src`` and move the library into ``out_dir`` atomically, so
    that processes building at once never load a half-written file."""
    cxx = _compiler()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        lib_tmp = Path(tmp) / lib_name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib_tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(lib_tmp, out_dir / lib_name)


@functools.lru_cache(maxsize=None)
def load_host_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cpp`` built (if this source hash has no library yet)
    and loaded. Raises if g++ is missing or the build fails."""
    src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib_name = f"lib{name}.so"
    out_dir = BUILD_ROOT / digest
    if not (out_dir / lib_name).exists():
        _build(src, out_dir, lib_name)
    return ctypes.CDLL(str(out_dir / lib_name))


def meshops() -> ctypes.CDLL:
    """``csrc/meshops.cpp`` with its entry points typed."""
    lib = load_host_library("meshops")
    lib.dedup_vertices.argtypes = [_P, _I64, _P, _P]
    lib.dedup_vertices.restype = _I64
    lib.emit_mc_triangles.argtypes = [_P, _P, _I64, _D, _P, _P, _P, _P, _P]
    lib.emit_mc_triangles.restype = _I64
    return lib


def rasterizer() -> ctypes.CDLL:
    """``csrc/rasterizer.cpp`` with its entry point typed."""
    lib = load_host_library("rasterizer")
    lib.rasterize_depth.argtypes = [_P, _I64, _P, _I64, _F, _F, _F, _F, _I32,
                                    _I32, _F, _P]
    lib.rasterize_depth.restype = None
    return lib


def jpeg_library() -> ctypes.CDLL:
    """``csrc/jpeg.cpp`` with its entry points typed."""
    lib = load_host_library("jpeg")
    lib.vfn_jpeg_info.argtypes = [ctypes.c_char_p, _I64, _P]
    lib.vfn_jpeg_info.restype = _I32
    lib.vfn_jpeg_decode.argtypes = [ctypes.c_char_p, _I64, _P, _I64]
    lib.vfn_jpeg_decode.restype = _I32
    lib.vfn_jpeg_error.argtypes = [_I32]
    lib.vfn_jpeg_error.restype = ctypes.c_char_p
    return lib
