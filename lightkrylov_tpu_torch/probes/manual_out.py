"""Does an asynchronous double-buffered copy beat a plain-store copy?

The counterpart of ``benchmarks/manual_out_probe.py``: the pipelined
(managed) Pallas copy P3 becomes ``copy_tiles`` in ``(64, n)`` row blocks,
with register loads and plain stores; the manual double-buffered copy P4,
whose both directions are async DMAs, becomes ``copy_ring`` at depth 2:
TMA bulk loads into a ring of two shared-memory stages and bulk stores out
of it, a producer thread and a store thread decoupled by full and empty
barriers, several rings an SM (as many as its shared memory holds, at most
8), with the TPU's ``rows`` mapped to a stage that fits
(:func:`.deep_buffer.ring_stage`).  Both are bound by twice the array's
bytes over the card's memory rate (3.35 TB/s on an H100 SXM).  Each is
checked on the ``[5000:5008, 1000:1032]`` window (the TPU's) and on the
whole array.

Run on the card: ``python -m lightkrylov_tpu_torch.probes.manual_out [--out PATH]``.
Prints one JSON line (``"probe": "manual_out"``).
"""

from __future__ import annotations

import time

import torch

from ..ops.probes import card_ring_geometry, copy_ring, copy_tiles, tiles_geometry
from .deep_buffer import ring_stage
from .timing import (cuda_device, datasheet_bw, device_kind, emit, health_gate, log,
                     parse_out, timed_loop)

ROWS = 64
WINDOW = (slice(5000, 5008), slice(1000, 1032))


def run(device, n=8192, min_diff=0.25, iters0=64):
    device = torch.device(device)
    kind = device_kind(device)
    sheet = datasheet_bw(kind)
    res = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"), "probe": "manual_out", "device_kind": kind,
           "rows": ROWS, "ring_stage_bytes": ring_stage(ROWS)}
    health_gate(device)
    x = torch.randn((n, n), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    res["footprint_MB"] = 2 * x.numel() * 4 / 1e6
    res["managed_grid"] = tiles_geometry(n, n, ROWS, n)[2]
    if device.type == "cuda":
        res["manual_grid"] = card_ring_geometry(device, x.numel() * 4, 2, ring_stage(ROWS))[2]
    for name, fn in (("managed", lambda v: copy_tiles(v, (ROWS, n))),
                     ("manual", lambda v: copy_ring(v, 2, ring_stage(ROWS)))):
        y = fn(x)
        if not (torch.equal(y[WINDOW], x[WINDOW]) and torch.equal(y, x)):
            raise RuntimeError(f"{name} copy differs from its input")
        t, d = timed_loop(fn, x, min_diff=min_diff, iters0=iters0)
        gbs = 2 * x.numel() * 4 / t / 1e9
        log(f"  {name}: {gbs:.0f} GB/s (valid={d['valid']})"
            + (f", {gbs * 1e9 / sheet:.3f} of datasheet" if sheet else ""))
        res[name + "_GBs"] = gbs
        res[name + "_valid"] = d["valid"]
    return res


def main(argv=None):
    args = parse_out(__doc__.splitlines()[0], argv)
    return emit(run(cuda_device()), args.out)


if __name__ == "__main__":
    main()
