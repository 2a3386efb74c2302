"""Copy through an asynchronous ring of depth 2, 3 and 4, over three stage
sizes.

The counterpart of ``benchmarks/deep_buffer_probe.py`` (its Pallas body P5):
the same nine ``(depth, rows)`` cases on an ``n``-square float32 array, each
through ``copy_ring``: a ring of ``depth`` shared-memory stages a CTA, TMA
bulk loads in and bulk stores out, a producer thread and a store thread
decoupled by full and empty barriers so that a freed stage is refilled at
once, and as many rings an SM as its shared memory holds (8 rings of 24 KB
down to 1 of 192 KB; ``grid`` in each case's line).  A TPU stage is
``rows`` rows of the array in VMEM, 2-8 MB; a Hopper stage lives in shared
memory (227 KB a CTA), so each case maps ``rows`` to :func:`ring_stage`
bytes, in the TPU's proportions, with ``depth * stage <= 192 KB``.  The
bound is twice the array's bytes over the card's memory rate (3.35 TB/s on
an H100 SXM).  The TPU case list and its 100 MiB rule are kept as the
labels.

Run on the card: ``python -m lightkrylov_tpu_torch.probes.deep_buffer [--out PATH]``.
Prints one JSON line (``"probe": "deep_buffer"``).
"""

from __future__ import annotations

import time

import torch

from ..ops.probes import card_ring_geometry, copy_ring
from .timing import (cuda_device, datasheet_bw, device_kind, emit, health_gate, log,
                     parse_out, timed_loop)

DEPTHS = (2, 3, 4)
ROWS = (64, 128, 256)
#: the TPU case's width: its 100 MiB rule is on (depth, rows) at this width
TPU_N = 8192


def ring_stage(rows: int) -> int:
    """Shared-memory stage in bytes standing for a TPU stage of ``rows``
    rows: 12 KB for 64 rows, in proportion, so that the deepest ring of the
    largest stage (4 x 48 KB) fits a CTA's shared memory."""
    return rows * 192


def cases():
    """The TPU's nine ``(depth, rows)`` cases (``deep_buffer_probe.py:105-108``)."""
    return [(d, r) for d in DEPTHS for r in ROWS if 2 * d * r * TPU_N * 4 <= 100 << 20]


def run(device, n=8192, min_diff=0.25, iters0=64):
    device = torch.device(device)
    kind = device_kind(device)
    sheet = datasheet_bw(kind)
    res = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"), "probe": "deep_buffer",
           "device_kind": kind, "cases": []}
    health_gate(device)
    x = torch.randn((n, n), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    nbytes = x.numel() * 4
    res["footprint_MB"] = 2 * nbytes / 1e6
    for depth, rows in cases():
        stage = ring_stage(rows)
        y = copy_ring(x, depth, stage)
        if not torch.equal(y, x):
            raise RuntimeError(f"copy_ring depth {depth} stage {stage} differs from its input")
        t, d = timed_loop(lambda v, depth=depth, stage=stage: copy_ring(v, depth, stage), x,
                          min_diff=min_diff, iters0=iters0)
        gbs = 2 * nbytes / t / 1e9
        grid = (card_ring_geometry(device, nbytes, depth, stage)[2]
                if device.type == "cuda" else None)
        log(f"depth={depth} rows={rows} (stage {stage} B, {depth * stage} B a ring, "
            f"grid {grid}): {gbs:.0f} GB/s (valid={d['valid']})"
            + (f", {gbs * 1e9 / sheet:.3f} of datasheet" if sheet else ""))
        res["cases"].append({"depth": depth, "rows": rows, "stage_bytes": stage, "grid": grid,
                             "GBs": gbs, "valid": d["valid"]})
    return res


def main(argv=None):
    args = parse_out(__doc__.splitlines()[0], argv)
    return emit(run(cuda_device()), args.out)


if __name__ == "__main__":
    main()
