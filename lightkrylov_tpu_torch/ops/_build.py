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

This module knows no kernel's signature.  A kernel is its ``csrc/<x>.cu``
and its ``ops/<x>.py``: the module declares the C entries it calls, with
their parameters, in an :class:`Entries`, names an entry's dtype with
:func:`dtype_tag`, and launches through :func:`launch`, which raises on a
CUDA error by :func:`check`, the one reader of ``lk_error_string``; a
persistent grid's size comes from :func:`resident_blocks`, given the
module's occupancy entry.  Each wrapper counts its launches itself, under
``launches.<wrapper>`` (:func:`..utils.timer.count_event`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["KernelCompileError", "find_nvcc", "build", "load", "load_lagging", "BUILD_DIR",
           "SOURCES", "DTYPE_TAGS", "ARG_TYPES", "Entries", "dtype_tag", "check", "launch",
           "resident_blocks"]

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
_resident_cache: dict = {}


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
    """The loaded kernel library, built first if needed.  Only
    ``lk_error_string`` is declared on it; each ``ops`` module declares the
    entries it calls (:class:`Entries`)."""
    global _lib
    if _lib is None:
        _lib = _open(build())
    return _lib


def load_lagging() -> ctypes.CDLL:
    """The lagging-warp build (``-DLK_LAG_WARP=1``) of the same sources,
    built first if needed, under its own name and handle: the shipping
    library of :func:`load` is never replaced by it."""
    global _lag_lib
    if _lag_lib is None:
        _lag_lib = _open(build("lag"))
    return _lag_lib


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.lk_error_string.argtypes = [ctypes.c_int]
    lib.lk_error_string.restype = ctypes.c_char_p
    return lib


# -- the seam between the wrappers and the C entries ----------------------------

#: The suffix of a C entry's name for each dtype the kernels take
DTYPE_TAGS = {torch.float32: "f32", torch.float64: "f64"}

#: The letters of a declared parameter list, one a parameter: ``p`` any
#: pointer, ``i`` an ``int``, ``l`` a ``long long``, ``d`` a ``double``
#: (spaces only group them)
ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
             "d": ctypes.c_double}


def dtype_tag(dtype, what: str) -> str:
    """``"f32"`` or ``"f64"``, the suffix of the C entries for ``dtype``;
    a :class:`TypeError` naming ``what`` for any other dtype."""
    tag = DTYPE_TAGS.get(dtype)
    if tag is None:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32 or float64)")
    return tag


class Entries:
    """The C entries that one ``ops`` module calls: ``declared`` maps each
    name to its parameters in the letters of :data:`ARG_TYPES`, in the order
    of the ``extern "C"`` prototype; every entry returns an ``int``, 0 or a
    CUDA error code.  :meth:`on` sets their types on a library handle, once
    a handle, and returns the entries by name."""

    def __init__(self, declared: dict[str, str]):
        self.declared = declared
        self._bound = {}

    def on(self, lib: ctypes.CDLL) -> dict:
        entries = self._bound.get(lib)
        if entries is None:
            entries = {}
            for name, params in self.declared.items():
                fn = getattr(lib, name)
                fn.argtypes = [ARG_TYPES[c] for c in params.replace(" ", "")]
                fn.restype = ctypes.c_int
                entries[name] = fn
            self._bound[lib] = entries
        return entries


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise a :class:`RuntimeError` for the nonzero return ``err`` of an
    entry of ``lib``, with the CUDA error's text; ``what`` names the call."""
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.lk_error_string(err).decode()})")


def resident_blocks(lib: ctypes.CDLL, fn, count: int, device) -> tuple:
    """The most blocks that a persistent grid of each of ``count`` kernels
    holds on ``device``: the entry ``fn`` fills their resident blocks an SM
    (the occupancy calculator's), each is taken at least once and times the
    SM count.  Cached per entry and device."""
    key = (fn.__name__, device.index)
    if key not in _resident_cache:
        per_sm = (ctypes.c_int * count)()
        check(lib, fn(per_sm), f"{fn.__name__} occupancy query")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident_cache[key] = tuple(max(1, b) * sms for b in per_sm)
    return _resident_cache[key]


def launch(lib: ctypes.CDLL, fn, what: str, index: int | None, *args) -> None:
    """Call the entry ``fn`` of ``lib`` with ``args`` and a raw stream handle
    last; a nonzero return raises, naming the kernel ``what``.  For a CUDA
    device ``index`` the handle is that device's current stream, appended to
    ``args``, and the device is made current for the call when it is not
    already.  For ``index`` None ``args`` end with the handle: the caller
    bound the stream once and holds its device current (``FusedCG``,
    ``FusedDCGS2``), so a step's launch costs the host no more than the call
    itself.  The raw handle costs less host time than a ``torch.cuda.Stream``
    object, which counts where a kernel runs for a few microseconds."""
    if index is None:
        err = fn(*args)
    elif torch._C._cuda_getDevice() == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        check(lib, err, f"{what} kernel launch")
