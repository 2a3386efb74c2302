"""Copy rate over the array's logical shape and the block shape.

The counterpart of ``benchmarks/copy_shape_probe.py`` (its Pallas body P7):
the same ten cases, the same 256 MB (and 512 MB) of float32 copied under
different logical shapes and block shapes through ``copy_tiles``, and eager
``a + 1.0`` on the 8192^2 array as the control.  Each case records the
kernel's grid, so that a shape effect can be told from an occupancy
effect, and its footprint (in and out) beside its rate.

Run on the card: ``python -m lightkrylov_tpu_torch.probes.copy_shape [--out PATH]``.
Prints one JSON line (``"probe": "copy_shape"``).
"""

from __future__ import annotations

import time

import torch

from ..ops.probes import copy_tiles, tiles_geometry
from .timing import (cuda_device, datasheet_bw, device_kind, emit, health_gate, log,
                     parse_out, timed_loop)

#: (label, shape, block): ``copy_shape_probe.py:75-87``
CASES = [
    ("8192x8192_rows256", (8192, 8192), (256, 8192)),
    ("8192x8192_rows64", (8192, 8192), (64, 8192)),
    ("8192x8192_blk256x1024", (8192, 8192), (256, 1024)),
    ("8192x8192_blk1024x256", (8192, 8192), (1024, 256)),
    ("8192x8192_blk64x2048", (8192, 8192), (64, 2048)),
    ("4096x4096_rows128", (4096, 4096), (128, 4096)),
    ("4096x16384_rows128", (4096, 16384), (128, 16384)),
    ("16384x4096_rows256", (16384, 4096), (256, 4096)),
    ("65536x1024_rows1024", (65536, 1024), (1024, 1024)),
    ("8192x8192_reshaped_32768x2048", (32768, 2048), (512, 2048)),
]


def run(device, cases=CASES, control_n=8192, min_diff=0.25, iters0=64):
    device = torch.device(device)
    kind = device_kind(device)
    sheet = datasheet_bw(kind)
    res = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"), "probe": "copy_shape",
           "device_kind": kind, "cases": []}
    health_gate(device)
    gen = torch.Generator(device=device).manual_seed(0)
    tl = dict(min_diff=min_diff, iters0=iters0)
    for label, shape, block in cases:
        x = torch.randn(shape, generator=gen, device=device)
        t, d = timed_loop(lambda v, block=block: copy_tiles(v, block), x, **tl)
        gbs = 2 * x.numel() * 4 / t / 1e9
        grid = tiles_geometry(*shape, *block)[2]
        case = {"label": label, "shape": list(shape), "block": list(block), "grid": grid,
                "footprint_MB": 2 * x.numel() * 4 / 1e6, "GBs": gbs,
                "frac": gbs * 1e9 / sheet if sheet else None, "valid": d["valid"]}
        log(f"  {label} (grid {grid}, {case['footprint_MB']:.0f} MB in and out): "
            f"{gbs:.0f} GB/s (valid={d['valid']})")
        res["cases"].append(case)
        del x
    x = torch.randn((control_n, control_n), generator=gen, device=device)
    t, d = timed_loop(lambda a: a + 1.0, x, **tl)
    gbs = 2 * x.numel() * 4 / t / 1e9
    log(f"  torch_add_{control_n}: {gbs:.0f} GB/s (valid={d['valid']})")
    res["cases"].append({"label": f"torch_add_{control_n}", "footprint_MB": 2 * x.numel() * 4 / 1e6,
                         "GBs": gbs, "frac": gbs * 1e9 / sheet if sheet else None,
                         "valid": d["valid"]})
    return res


def main(argv=None):
    args = parse_out(__doc__.splitlines()[0], argv)
    return emit(run(cuda_device()), args.out)


if __name__ == "__main__":
    main()
