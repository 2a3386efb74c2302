"""The bandwidth probes' kernels: tiled copy, async-ring copy and the
``(8, 128)`` partial-sum reduction, through ``csrc/probes.cu``.

Counterparts of the Pallas bodies of the TPU probes in ``benchmarks/``
(``roofline_probe.py``, ``manual_out_probe.py``, ``deep_buffer_probe.py``,
``stencil_sweep.py``, ``copy_shape_probe.py``), which
:mod:`lightkrylov_tpu_torch.probes` drives.  All take float32 only, as on
the TPU.

For a CUDA tensor a wrapper launches its kernel or raises: a wrong dtype, a
non-contiguous or misaligned input, a block that does not divide the array,
a failed build or a refused launch is an error, never a quiet switch to
another path.  For a CPU tensor it computes the plain version,
:func:`copy_reference` or :func:`reduce_8x128_reference`.  Each wrapper
counts its kernel launches in the counter ``launches.<wrapper>``
(:func:`..utils.timer.count_event`).

The launch geometry is computed here (:func:`tiles_geometry`,
:func:`ring_geometry`, :func:`reduce_grid`) and handed to the kernels, so
that the probes can print it beside each reading; the rings an SM of
``copy_ring`` come from the card's own occupancy calculator
(:func:`ring_ctas_per_sm`).  All three kernels are bound by device-memory
bytes: the bound of a copy is twice the array's bytes over the card's rate
(3.35 TB/s on an H100 SXM).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timer import count_event
from . import _build

__all__ = ["copy_tiles", "copy_ring", "reduce_8x128", "copy_reference",
           "reduce_8x128_reference", "tiles_geometry", "ring_geometry", "card_ring_geometry",
           "ring_chunks", "ring_ctas_per_sm", "reduce_grid", "RING_SMEM_MAX"]

#: floats a CTA of ``copy_tiles`` copies at most: 16 KB, 4 float4 a thread
UNIT_FLOATS = 4096
#: CTAs an SM of the reduction's first pass (8 ran faster than 4 at
#: 65536 x 1024 on an H100, and as fast at 4096^2)
REDUCE_CTAS_PER_SM = 8
#: shared memory the ring may take: 227 KB a CTA, less 1 KB for its barriers
RING_SMEM_MAX = 227 * 1024 - 1024
RING_MAX_DEPTH = 8
#: ring CTAs an SM at most
RING_MAX_CTAS_PER_SM = 8

#: The C entries of ``csrc/probes.cu`` (:class:`._build.Entries`)
ENTRIES = _build.Entries({
    "lk_copy_tiles_f32": "pp ll iiii p",
    "lk_copy_ring_f32": "pp l iii p",
    "lk_copy_ring_ctas_per_sm": "ii p",
    "lk_reduce_8x128_f32": "ppp ll i p",
})

_SM_COUNT = {}
#: (device index, depth x stage bytes) -> ring CTAs an SM of that device holds
_RING_FITS = {}


def copy_reference(x):
    """Plain version of both copy kernels."""
    return torch.empty_like(x).copy_(x)


def reduce_8x128_reference(x):
    """Plain version of :func:`reduce_8x128`: ``s[r, c]`` is the sum of
    ``x[i, j]`` over ``i % 8 == r`` and ``j % 128 == c``."""
    ny, nx = x.shape
    return x.reshape(ny // 8, 8, nx // 128, 128).sum(dim=(0, 2))


def tiles_geometry(ny: int, nx: int, by: int, bx: int):
    """``(unit_rows, unit_cols, grid)`` of :func:`copy_tiles` on an
    ``(ny, nx)`` array in TPU blocks ``(by, bx)``: a CTA copies one unit of
    ``unit_rows x unit_cols`` of a block (the widest multiple of 4 dividing
    ``bx``, then the most rows dividing ``by``, within :data:`UNIT_FLOATS`,
    16 KB), its four loads a thread before its stores, and the grid has one
    CTA a unit, numbered block by block in the TPU grid's order.  The copy
    is bound by twice the array's bytes over the card's memory rate."""
    unit_cols = min(bx, UNIT_FLOATS) // 4 * 4
    while bx % unit_cols:
        unit_cols -= 4
    unit_rows = min(by, UNIT_FLOATS // unit_cols)
    while by % unit_rows:
        unit_rows -= 1
    return unit_rows, unit_cols, (ny // unit_rows) * (nx // unit_cols)


def ring_geometry(nbytes: int, stage: int, sm_count: int, ctas_per_sm: int):
    """``(n_chunks, rings_per_sm, grid)`` of :func:`copy_ring`: chunks of
    one stage; as many rings (one a CTA) an SM as it holds at once,
    ``ctas_per_sm`` (what the card reports, :func:`ring_ctas_per_sm`), at
    most :data:`RING_MAX_CTAS_PER_SM`; and ``rings_per_sm x sm_count`` CTAs,
    or one a chunk where there are fewer chunks (CTA ``b`` takes the chunks
    :func:`ring_chunks` gives it).  Every ring is resident at once, so the
    bytes in flight an SM are up to ``rings_per_sm x depth x stage``, and
    the copy is bound by twice ``nbytes`` over the card's memory rate."""
    if ctas_per_sm < 1:
        raise ValueError(f"copy_ring: the SM holds {ctas_per_sm} rings of this size")
    n_chunks = -(-nbytes // stage)
    rings = min(RING_MAX_CTAS_PER_SM, ctas_per_sm)
    return n_chunks, rings, min(n_chunks, rings * sm_count)


def ring_chunks(n_chunks: int, grid: int, b: int) -> range:
    """The chunks CTA ``b`` of a ``grid``-CTA ring copy takes, the kernel's
    own rule: ``b, b + grid, ...``, so that the CTAs' counts differ by at
    most one and the card works on one window of the array at a time."""
    return range(b, n_chunks, grid)


def reduce_grid(ny: int, nx: int, sm_count: int) -> int:
    """CTAs of the reduction's first pass: one ``(8, 128)`` partial each."""
    return min((ny // 8) * (nx // 128), REDUCE_CTAS_PER_SM * sm_count)


def _check(x, what: str, ndim: int | None = 2):
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32 only)")
    if ndim is not None and x.ndim != ndim:
        raise ValueError(f"{what}: expected a {ndim}-D array, got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{what}: the array is empty")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the array must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: the array must start on a 16-byte boundary")


def _index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _sm_count(device) -> int:
    index = _index(device)
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _launch(what: str, name: str, x, *args):
    """Launch the entry ``name`` with ``args`` on the current stream of
    ``x``'s device (:func:`._build.launch`)."""
    lib = _build.load()
    _build.launch(lib, ENTRIES.on(lib)[name], what, x.device.index, *args)


def ring_ctas_per_sm(device, depth: int, stage: int) -> int:
    """Ring CTAs of ``depth x stage`` bytes one SM of the CUDA
    ``torch.device`` holds at once, as the card's occupancy calculator
    reports it (with the kernel's shared-memory attributes set); asked once
    a size."""
    key = (_index(device), depth * stage)
    if key not in _RING_FITS:
        lib = _build.load()
        out = ctypes.c_int()
        with torch.cuda.device(key[0]):
            err = ENTRIES.on(lib)["lk_copy_ring_ctas_per_sm"](stage, depth, ctypes.byref(out))
        _build.check(lib, err, "copy_ring occupancy query")
        _RING_FITS[key] = out.value
    return _RING_FITS[key]


def card_ring_geometry(device, nbytes: int, depth: int, stage: int):
    """:func:`ring_geometry` of a copy of ``nbytes`` on the CUDA
    ``torch.device``: its SM count and the rings an SM it holds."""
    return ring_geometry(nbytes, stage, _sm_count(device), ring_ctas_per_sm(device, depth, stage))


def copy_tiles(x, block):
    """``y = x`` for an ``(ny, nx)`` float32 array copied in TPU blocks
    ``block = (by, bx)`` (16-byte loads, plain stores): the counterpart of
    the row-block and 2-D-grid Pallas copies P1, P3, P6 and P7.  ``block``
    must divide the array, and ``bx`` be a multiple of 4."""
    _check(x, "copy_tiles")
    (ny, nx), (by, bx) = x.shape, block
    if by < 1 or bx < 1 or ny % by or nx % bx:
        raise ValueError(f"copy_tiles: block {tuple(block)} does not divide shape {(ny, nx)}")
    if bx % 4:
        raise ValueError(f"copy_tiles: block width {bx} is not a multiple of 4 floats")
    if x.device.type == "cpu":
        return copy_reference(x)
    unit_rows, unit_cols, _ = tiles_geometry(ny, nx, by, bx)
    y = torch.empty_like(x)
    _launch("copy_tiles", "lk_copy_tiles_f32", x, x.data_ptr(), y.data_ptr(), ny, nx, by, bx,
            unit_rows, unit_cols)
    count_event("launches.copy_tiles")
    return y


def copy_ring(x, depth: int, stage: int):
    """``y = x`` for a contiguous float32 array of any shape, through rings
    of ``depth`` shared-memory stages of ``stage`` bytes, loaded by TMA bulk
    copies and stored by bulk stores, several rings an SM
    (:func:`card_ring_geometry`): the counterpart of the manual-DMA Pallas copies
    P4 (depth 2) and P5.  ``depth`` is 2-8, ``stage`` a multiple of 16, and
    ``depth * stage`` at most :data:`RING_SMEM_MAX`."""
    _check(x, "copy_ring", ndim=None)
    if not 2 <= depth <= RING_MAX_DEPTH:
        raise ValueError(f"copy_ring: depth {depth} outside 2-{RING_MAX_DEPTH}")
    if stage < 16 or stage % 16 or depth * stage > RING_SMEM_MAX:
        raise ValueError(f"copy_ring: stage of {stage} bytes is not a multiple of 16, or "
                         f"{depth} stages exceed {RING_SMEM_MAX} bytes of shared memory")
    nbytes = x.numel() * 4
    if nbytes % 16:
        raise ValueError(f"copy_ring: {nbytes} bytes is not a multiple of 16")
    if x.device.type == "cpu":
        return copy_reference(x)
    _, _, grid = card_ring_geometry(x.device, nbytes, depth, stage)
    y = torch.empty_like(x)
    _launch("copy_ring", "lk_copy_ring_f32", x, x.data_ptr(), y.data_ptr(), nbytes, stage,
            depth, grid)
    count_event("launches.copy_ring")
    return y


def reduce_8x128(x):
    """The ``(8, 128)`` block of partial sums of an ``(ny, nx)`` float32
    array, ``ny % 8 == 0`` and ``nx % 128 == 0``: the counterpart of the
    Pallas read-reduce P2.  Two passes and no atomics, so a result repeats
    bit for bit (on the CPU: :func:`reduce_8x128_reference`)."""
    _check(x, "reduce_8x128")
    ny, nx = x.shape
    if ny % 8 or nx % 128:
        raise ValueError(f"reduce_8x128: shape {(ny, nx)} is not a multiple of (8, 128)")
    if x.device.type == "cpu":
        return reduce_8x128_reference(x)
    grid = reduce_grid(ny, nx, _sm_count(x.device))
    # the first pass's partials, then the result: one allocation
    buf = torch.empty(((grid + 1) * 8, 128), dtype=x.dtype, device=x.device)
    out = buf[grid * 8:]
    _launch("reduce_8x128", "lk_reduce_8x128_f32", x, x.data_ptr(), buf.data_ptr(),
            out.data_ptr(), ny, nx, grid)
    count_event("launches.reduce_8x128")
    return out
