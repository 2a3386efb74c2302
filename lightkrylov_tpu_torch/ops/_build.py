"""Build and load the package's CUDA kernels.

The sources in ``lightkrylov_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``.  The build happens on first use, into
``lightkrylov_tpu_torch/_build/``, under a name keyed by a hash of the
sources, so an edited source is rebuilt.  It uses nothing but the sources in
this package and the CUDA toolkit.  A missing compiler or a failed build
raises :class:`KernelCompileError`; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KernelCompileError", "find_nvcc", "build", "load", "BUILD_DIR", "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "stencil.cu", _PKG / "csrc" / "spmv.cu", _PKG / "csrc" / "probes.cu")
BUILD_DIR = _PKG / "_build"

#: Where the CUDA toolkit is looked for when neither ``CUDA_HOME`` nor
#: ``PATH`` names an ``nvcc``.
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


class KernelCompileError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def find_nvcc() -> str | None:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    default toolkit location; ``None`` when there is none."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblk_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    return its path.  The compiler's output, register and shared-memory use
    included, is kept beside the library as ``<name>.log``."""
    path = _library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelCompileError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA toolkit is needed to build "
            "the CUDA kernels for a CUDA tensor")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("lk_stencil_f32", "lk_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("lk_stencil_batched_f32", "lk_stencil_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("lk_bell_spmv_f32", "lk_bell_spmv_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("lk_bell_spmm_f32", "lk_bell_spmm_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lk_copy_tiles_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lk_copy_ring_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lk_reduce_8x128_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
        for name in ("lk_copy_tiles_f32", "lk_copy_ring_f32", "lk_reduce_8x128_f32"):
            getattr(lib, name).restype = ctypes.c_int
        lib.lk_error_string.argtypes = [ctypes.c_int]
        lib.lk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
