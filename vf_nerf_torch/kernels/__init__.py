"""Build and bind the port's CUDA kernels.

The sources in ``vf_nerf_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together, then one link)
into ``build/kernels/<hash>/libvf_nerf_kernels.so`` under the repository
root, keyed by a hash of the sources, at the first call of
``load_library()``. The library has a plain C interface and is loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds. Nothing is compiled or loaded when this module is imported.
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
from typing import List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libvf_nerf_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "the CUDA kernels of vf_nerf_torch need nvcc (CUDA toolkit) to build; "
        "none was found on PATH or under $CUDA_HOME")


class KernelLibrary:
    """The loaded shared library, with its C entry points typed."""

    def __init__(self, path: Path, build_log: str):
        self.path = path
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        lib.vfn_fused_mlp.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                                      _I, _P, _I, _P]
        lib.vfn_fused_mlp.restype = _I
        lib.vfn_fused_mlp_acts_pitch.argtypes = []
        lib.vfn_fused_mlp_acts_pitch.restype = _I
        lib.vfn_fused_mlp_max_width.argtypes = []
        lib.vfn_fused_mlp_max_width.restype = _I
        lib.vfn_fused_mlp_max_hidden.argtypes = []
        lib.vfn_fused_mlp_max_hidden.restype = _I
        lib.vfn_ray_march.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _F, _F, _F, _F, _F, _F, _F,
                                      _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.vfn_ray_march.restype = _I
        lib.vfn_ray_march_backward.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _F,
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.vfn_ray_march_backward.restype = _I
        lib.vfn_ray_march_max_samples.argtypes = []
        lib.vfn_ray_march_max_samples.restype = _I
        lib.vfn_ray_march_max_taps.argtypes = []
        lib.vfn_ray_march_max_taps.restype = _I
        lib.vfn_error_string.argtypes = [_I]
        lib.vfn_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib.vfn_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    ``out_dir`` atomically. Returns the compilers' output."""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(obj) for _, obj, _ in procs], "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = "\n".join(logs)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "build.log").write_text(log)
        os.replace(lib_tmp, out_dir / LIB_NAME)
    return log


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build the kernels if this source hash has no library yet, then load
    it. Raises if nvcc is missing or a build fails."""
    out_dir = BUILD_ROOT / _source_hash()
    path = out_dir / LIB_NAME
    if path.exists():
        log = (out_dir / "build.log").read_text() \
            if (out_dir / "build.log").exists() else ""
    else:
        log = _build(out_dir)
    return KernelLibrary(path, log)
