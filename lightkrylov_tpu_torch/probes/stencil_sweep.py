"""Copy rate over the row-block size, and the stencils against it, at an
array too large for L2.

The counterpart of ``benchmarks/stencil_sweep.py`` (its Pallas body P6) at
8192^2 float32 (256 MiB, five times the H100's 50 MB L2): ``copy_tiles`` in
``(rows, n)`` blocks for rows 128, 256 and 512, eager ``a + 1.0``, and the
plain ``Poisson2D`` and kernel ``CudaPoisson2D`` stencils.  The JAX probe
then sweeps the Pallas stencil's (tile, VMEM budget) pairs; the CUDA
stencil's tiling is fixed (a thread a column, 16 rows: ``ops/stencil.py``),
so one kernel line stands in its place.

Run on the card: ``python -m lightkrylov_tpu_torch.probes.stencil_sweep [--out PATH]``.
Prints one JSON line (``"probe": "stencil_sweep_8192"``).
"""

from __future__ import annotations

import time

import torch

from ..models import Poisson2D
from ..ops.probes import copy_tiles, tiles_geometry
from ..ops.stencil import CudaPoisson2D
from .timing import (cuda_device, datasheet_bw, device_kind, emit, health_gate, log,
                     parse_out, timed_loop)

ROWS = (128, 256, 512)


def run(device, n=8192, min_diff=0.25, iters0=64):
    device = torch.device(device)
    kind = device_kind(device)
    res = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"), "probe": "stencil_sweep_8192",
           "device_kind": kind, "n": n}
    health_gate(device)
    u = torch.randn((n, n), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    nbytes = u.numel() * 4
    nnz = 5 * n * n - 4 * n
    tl = dict(min_diff=min_diff, iters0=iters0)

    res["copy_sweep"] = []
    bw_copy = 0.0
    for rows in ROWS:
        t, d = timed_loop(lambda v, rows=rows: copy_tiles(v, (rows, n)), u, **tl)
        bw = 2 * nbytes / t
        grid = tiles_geometry(n, n, rows, n)[2]
        log(f"cuda copy {n}^2 rows={rows} (grid {grid}): {bw / 1e9:.1f} GB/s "
            f"(valid={d['valid']})")
        res["copy_sweep"].append({"rows": rows, "grid": grid, "GBs": bw / 1e9,
                                  "valid": d["valid"]})
        bw_copy = max(bw_copy, bw)
    res["cuda_copy_GBs"] = bw_copy / 1e9
    sheet = datasheet_bw(kind) or bw_copy

    t, d = timed_loop(lambda a: a + 1.0, u, **tl)
    log(f"torch a+1.0 {n}^2: {2 * nbytes / t / 1e9:.1f} GB/s (valid={d['valid']})")
    res["torch_stream_GBs"] = 2 * nbytes / t / 1e9
    t, d = timed_loop(Poisson2D(n, dtype=torch.float32, device=device).matvec, u, **tl)
    log(f"torch stencil {n}^2: {nnz / t / 1e9:.2f} Gnnz/s "
        f"({2 * nbytes / t / 1e9:.1f} GB/s eff, valid={d['valid']})")
    res["torch_stencil_Gnnzs"] = nnz / t / 1e9

    t, d = timed_loop(CudaPoisson2D(n, dtype=torch.float32, device=device).matvec, u, **tl)
    g, ebw = nnz / t / 1e9, 2 * nbytes / t
    log(f"cuda stencil (K1, fixed tiling) {n}^2: {g:.2f} Gnnz/s eff_bw={ebw / 1e9:.1f} GB/s "
        f"vs_copy={ebw / bw_copy:.3f} vs_datasheet={ebw / sheet:.3f} valid={d['valid']}")
    res["sweep"] = [{"kernel": "K1", "tiling": "fixed: a thread a column, 16 rows",
                     "Gnnzs": g, "eff_GBs": ebw / 1e9, "frac_of_copy": ebw / bw_copy,
                     "frac_of_datasheet": ebw / sheet, "valid": d["valid"]}]
    res["sweep_note"] = ("the JAX probe sweeps PallasPoisson2D's (tile, vmem budget) pairs; "
                         "the CUDA stencil's tiling is fixed, so one K1 line stands in its place")
    return res


def main(argv=None):
    args = parse_out(__doc__.splitlines()[0], argv)
    return emit(run(cuda_device()), args.out)


if __name__ == "__main__":
    main()
