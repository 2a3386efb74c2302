"""Build and load the package's CUDA kernels.

The sources in ``lightkrylov_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``.  The build happens on first use, into
``lightkrylov_tpu_torch/_build/``, under a name keyed by a hash of the
sources, so an edited source is rebuilt: one ``nvcc`` a source, all started
together, then one link.  It uses nothing but the sources in
this package and the CUDA toolkit.  A missing compiler or a failed build
raises :class:`KernelCompileError`; nothing falls back to another path.

:func:`load_lagging` builds and loads, beside it and through a handle of its
own, the same sources with ``-DLK_LAG_WARP=1``: the Francis-QR kernels of
``csrc/hessenberg.cu``, the Ritz kernel's staging in ``csrc/ritz.cu`` and
the reordering of ``csrc/ordschur.cu`` with one warp made to lag in every
stretch between two barriers, whose outputs the
tests hold bit-equal to the shipping kernels' (a check for ordering hazards
between warps).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KernelCompileError", "find_nvcc", "build", "load", "load_lagging", "BUILD_DIR",
           "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f"{name}.cu"
                for name in ("stencil", "spmv", "probes", "hessenberg", "ritz", "ordschur",
                             "cg", "gmres"))
BUILD_DIR = _PKG / "_build"

#: Where the CUDA toolkit is looked for when neither ``CUDA_HOME`` nor
#: ``PATH`` names an ``nvcc``.
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: ``NVCC_FLAGS`` less ``-shared``: what compiles one source to an object
_COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")
#: The builds beside the shipping one (``""``), by name: their extra flags
VARIANTS = {"": (), "lag": ("-DLK_LAG_WARP=1",)}

_lib = None
_lag_lib = None


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


def _library_path(variant: str = "") -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + VARIANTS[variant]).encode())
    name = f"liblk_kernels_{variant}_" if variant else "liblk_kernels_"
    return BUILD_DIR / f"{name}{digest.hexdigest()[:16]}.so"


def _compile(nvcc: str, sources, path: Path, extra=()) -> None:
    """Compile ``sources`` into the shared library ``path``: one ``nvcc -c``
    a source, all started together, with the flags ``extra`` besides, then
    one link.  The compilers' output, register and shared-memory use
    included, is kept beside the library as ``<name>.log``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [path.with_name(f"{tag}.{i}.o") for i in range(len(sources))]
    cmds = [[nvcc, *_COMPILE_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = ["\n".join((" ".join(cmd), out)) for cmd, out in zip(cmds, outs)]
    failed = [(cmd, proc.returncode, out) for cmd, proc, out in zip(cmds, procs, outs)
              if proc.returncode != 0]
    tmp = path.with_name(f"{tag}.tmp.so")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append((cmd, proc.returncode, proc.stderr))
    path.with_suffix(".log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, code, out = failed[0]
        raise KernelCompileError(f"nvcc failed with exit code {code} ({cmd[-1]}):\n{out}")
    os.replace(tmp, path)


def build(variant: str = "") -> Path:
    """Compile the kernels unless a library for the current sources exists;
    return its path (the compilers' output is in ``<name>.log`` beside it).
    ``variant`` names a build of :data:`VARIANTS` (``""``: the shipping
    one)."""
    path = _library_path(variant)
    if path.exists():
        return path
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelCompileError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA toolkit is needed to build "
            "the CUDA kernels for a CUDA tensor")
    _compile(nvcc, SOURCES, path, VARIANTS[variant])
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def load_lagging() -> ctypes.CDLL:
    """The lagging-warp build (``-DLK_LAG_WARP=1``) of the same sources,
    built first if needed, under its own name and handle: the shipping
    library of :func:`load` is never replaced by it."""
    global _lag_lib
    if _lag_lib is None:
        _lag_lib = _bind(ctypes.CDLL(str(build("lag"))))
    return _lag_lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on ``lib``."""
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
    lib.lk_copy_ring_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.lk_reduce_8x128_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
    for name in ("lk_copy_tiles_f32", "lk_copy_ring_f32", "lk_copy_ring_ctas_per_sm",
                 "lk_reduce_8x128_f32"):
        getattr(lib, name).restype = ctypes.c_int
    for name in ("lk_hessenberg_schur_f32", "lk_hessenberg_schur_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in ("lk_francis_sweeps_f32", "lk_francis_sweeps_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_void_p, ctypes.c_int,
                                                ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in ("lk_ritz_f32", "lk_ritz_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
                                                ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in ("lk_ordschur_f32", "lk_ordschur_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for t in ("f32", "f64"):
        fn = getattr(lib, f"lk_cg_pdot_{t}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int, ctypes.c_void_p]
        fn = getattr(lib, f"lk_cg_xr_{t}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn = getattr(lib, f"lk_cg_p_{t}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        getattr(lib, f"lk_cg_blocks_per_sm_{t}").argtypes = [ctypes.POINTER(ctypes.c_int)]
        for kind in ("pdot", "xr", "p", "blocks_per_sm"):
            getattr(lib, f"lk_cg_{kind}_{t}").restype = ctypes.c_int
    for t in ("f32", "f64"):
        fn = getattr(lib, f"lk_dcgs2_{t}")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 6 + [ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.lk_error_string.argtypes = [ctypes.c_int]
    lib.lk_error_string.restype = ctypes.c_char_p
    return lib
