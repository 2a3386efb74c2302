"""Native (C++) host tier: Block-ELL assembly.

Counterpart of :mod:`lightkrylov_tpu.native`.  Its source is the port's
own copy of the JAX package's assembler,
``lightkrylov_tpu_torch/csrc/bell_assembler.cpp``.  On first use ``g++``
builds it into ``lightkrylov_tpu_torch/_build/``, under a name keyed by a
hash of the source and flags, and ``ctypes`` loads it.

As in the JAX package, a missing compiler or source, or a failed build,
makes :func:`available` false, and ``bell_from_scipy`` then assembles with
numpy (same layout).  This is host-side preparation, not a device path;
:func:`unavailable_reason` says why the native path is off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "bell_assemble", "unavailable_reason", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bell_assembler.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_reason = None


def _build_and_load():
    global _reason
    if not SOURCE.is_file():
        _reason = f"source {SOURCE} not found"
        return None
    cxx = shutil.which("g++")
    if cxx is None:
        _reason = "g++ not found on PATH"
        return None
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    path = BUILD_DIR / f"libbell_assembler_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            _reason = f"g++ failed with exit code {proc.returncode}: {proc.stderr}"
            return None
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _reason = f"could not load {path}: {e}"
        return None
    lib.bell_compute_k.restype = ctypes.c_int32
    lib.bell_compute_k.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    for name in ("bell_fill_f32", "bell_fill_f64"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build_and_load()
        return _lib


def available() -> bool:
    """Whether the native assembler is built and loaded (built on first
    call)."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why :func:`available` is false, or ``None`` when it is true."""
    return None if available() else _reason


def bell_assemble(csr, bm: int, bn: int, dtype=np.float32):
    """CSR -> ``(data, cols, K)`` Block-ELL numpy arrays through the native
    assembler, with the layout contract of :mod:`..ops.spmv`.

    ``csr`` is a ``scipy.sparse.csr_matrix`` with summed duplicates;
    ``dtype`` is float32 or float64.  Raises ``RuntimeError`` when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native bell assembler unavailable: {_reason}")
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"native bell assembler: dtype {dtype} not supported")
    m, _ = csr.shape
    indptr = np.ascontiguousarray(csr.indptr, np.int64)
    indices = np.ascontiguousarray(csr.indices, np.int32)
    values = np.ascontiguousarray(csr.data, np.float64)
    K = lib.bell_compute_k(indptr.ctypes.data, indices.ctypes.data,
                           ctypes.c_int64(m), ctypes.c_int32(bm), ctypes.c_int32(bn))
    nbr = -(-m // bm)
    data = np.zeros((nbr, K, bm, bn), dtype)
    cols = np.zeros((nbr, K), np.int32)
    fill = lib.bell_fill_f32 if dtype == np.float32 else lib.bell_fill_f64
    fill(indptr.ctypes.data, indices.ctypes.data, values.ctypes.data,
         ctypes.c_int64(m), ctypes.c_int32(bm), ctypes.c_int32(bn),
         ctypes.c_int32(K), data.ctypes.data, cols.ctypes.data)
    return data, cols, int(K)
