"""Roofline probe: the card's copy and read-only bandwidth, and its matmul
rates, through constructs that measure what they say.

The counterpart of ``benchmarks/roofline_probe.py`` (its Pallas bodies P1
and P2):

1. ``copy_tiles`` in ``(128, n)`` row blocks (P1) -> achievable copy rate,
   with a linearity check of the loop itself (``K``, ``2K``, ``4K`` steps);
2. ``reduce_8x128`` (P2) -> read-only rate, alone (one read stream) and with
   the TPU wrapper's ``x + s[0, 0] * 1e-30`` update (three streams, the
   TPU's ``pallas_reduce3_GBs`` accounting);
3. eager ``a + 1.0``: eager torch does not fuse a chain, so the TPU's "with
   barrier" and "no barrier" lines are one here;
4. the plain ``Poisson2D`` and the kernel ``CudaPoisson2D`` stencils at
   3072^2 in Gnnz/s;
5. the ``n``-cube matmul in bf16 and in f32 with TF32 off (``torch.matmul``;
   the JAX probe also computes it outside Pallas).

Run on the card: ``python -m lightkrylov_tpu_torch.probes.roofline [--out PATH]``.
Prints one JSON line (``"probe": "roofline"``).  Field names are the TPU
probe's, with ``pallas_`` as ``cuda_`` and the XLA lines as ``torch_``.
"""

from __future__ import annotations

import time

import torch

from ..models import Poisson2D
from ..ops.probes import copy_tiles, reduce_8x128, reduce_grid, tiles_geometry
from ..ops.stencil import CudaPoisson2D
from .timing import (cuda_device, datasheet_bw, device_kind, emit, health_gate, log,
                     parse_out, sm_count, sync_for, timed_loop)

ROWS = 128


def run(device, n=4096, nb=3072, nmm=4096, min_diff=0.25, iters0=64):
    """Measure on ``device``; return the result dict.  ``n`` is the copy and
    reduce array's side, ``nb`` the stencil's, ``nmm`` the matmul's."""
    device = torch.device(device)
    kind = device_kind(device)
    sheet = datasheet_bw(kind)
    res = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"), "probe": "roofline", "device_kind": kind,
           "datasheet_GBs": sheet / 1e9 if sheet else None}
    health_gate(device)
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn((n, n), generator=gen, device=device)
    nbytes = w.numel() * 4
    res["footprint_MB"] = 2 * nbytes / 1e6
    res["cuda_copy_grid"] = tiles_geometry(n, n, ROWS, n)[2]
    sms = sm_count(device)
    if sms:
        res["cuda_reduce_grid"] = reduce_grid(n, n, sms)
    tl = dict(min_diff=min_diff, iters0=iters0)

    def reading(name, t, d, nb_moved):
        bw = nb_moved / t
        log(f"{name}: {bw / 1e9:.1f} GB/s (valid={d['valid']}, iters={d['iters']})"
            + (f", {bw / sheet:.3f} of datasheet" if sheet else ""))
        return bw

    # 1. copy, and the loop's linearity
    t, d = timed_loop(lambda v: copy_tiles(v, (ROWS, n)), w, **tl)
    res["cuda_copy_GBs"] = reading(f"cuda copy {n}^2 rows {ROWS}", t, d, 2 * nbytes) / 1e9
    res["cuda_copy_valid"] = d["valid"]
    sync = sync_for(device)
    k = max(iters0, d["iters"] // 2)
    ts = {}
    for mult in (1, 2, 4):
        t0 = time.perf_counter()
        v = w
        for _ in range(k * mult):
            v = copy_tiles(v, (ROWS, n))
        sync()
        ts[mult] = time.perf_counter() - t0
    lin = (ts[4] - ts[2]) / (ts[2] - ts[1]) if ts[2] > ts[1] else float("nan")
    log(f"linearity t(k)/t(2k)/t(4k) = {ts[1]:.4f}/{ts[2]:.4f}/{ts[4]:.4f} s "
        f"(slope ratio {lin:.3f}, expect ~2.0)")
    res["linearity_ratio"] = lin

    # 2. read-reduce: alone, and with the TPU wrapper's XLA-side update
    t, d = timed_loop(lambda v: (reduce_8x128(v), v)[1], w, **tl)
    res["cuda_reduce_GBs"] = reading("cuda read-reduce alone (1 stream)", t, d, nbytes) / 1e9
    res["cuda_reduce_valid"] = d["valid"]
    t, d = timed_loop(lambda v: v + reduce_8x128(v)[0, 0] * 1e-30, w, **tl)
    res["cuda_reduce3_GBs"] = reading("cuda read-reduce + torch update (3 streams)", t, d,
                                      3 * nbytes) / 1e9
    res["cuda_reduce3_valid"] = d["valid"]

    # 3. eager elementwise stream
    t, d = timed_loop(lambda a: a + 1.0, w, **tl)
    res["torch_stream_GBs"] = reading("torch a+1.0", t, d, 2 * nbytes) / 1e9
    res["torch_stream_note"] = ("eager torch launches each a+1.0 as its own kernel and "
                                "fuses no chain: the TPU's barrier and no-barrier lines are one")

    # 4. stencils
    gen.manual_seed(1)
    ub = torch.randn((nb, nb), generator=gen, device=device)
    nnz = 5 * nb * nb - 4 * nb
    for name, op in (("torch", Poisson2D(nb, dtype=torch.float32, device=device)),
                     ("cuda", CudaPoisson2D(nb, dtype=torch.float32, device=device))):
        t, d = timed_loop(op.matvec, ub, **tl)
        log(f"{name} stencil {nb}^2: {nnz / t / 1e9:.2f} Gnnz/s "
            f"({2 * nb * nb * 4 / t / 1e9:.1f} GB/s effective, valid={d['valid']})")
        res[f"{name}_stencil_Gnnzs"] = nnz / t / 1e9
        res[f"{name}_stencil_valid"] = d["valid"]

    # 5. matmul rates, f32 with TF32 off
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a = (torch.randn((nmm, nmm), generator=gen, device=device) / nmm**0.5).to(dt)
            t, d = timed_loop(lambda x, a=a: torch.matmul(a, x), a, **tl)
            log(f"matmul {name} {nmm}^3: {2 * nmm**3 / t / 1e12:.1f} TFLOP/s "
                f"(valid={d['valid']})")
            res[f"matmul_{name}_TFLOPs"] = 2 * nmm**3 / t / 1e12
            res[f"matmul_{name}_valid"] = d["valid"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res["matmul_f32_tf32"] = False
    return res


def main(argv=None):
    args = parse_out(__doc__.splitlines()[0], argv)
    return emit(run(cuda_device()), args.out)


if __name__ == "__main__":
    main()
