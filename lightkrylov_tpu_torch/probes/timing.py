"""What the probes share: the datasheet rates, the differential timing loop,
the health gate, and the JSON line.

The counterpart of ``bench.py``'s ``DATASHEET_HBM``/``datasheet_bw`` and
``timed_loop`` and of the probes' health gate (``roofline_probe.py:53-59``),
written for eager PyTorch on a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

__all__ = ["DATASHEET_BW", "datasheet_bw", "timed_loop", "health_gate", "device_kind",
           "sm_count", "sync_for", "cuda_device", "parse_out", "emit", "log"]

#: Datasheet device-memory rate (bytes/s) by ``torch.cuda.get_device_name``.
#: Sources: NVIDIA's H100 datasheet (SXM 3.35 TB/s, PCIe 2.0 TB/s).
DATASHEET_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def datasheet_bw(name: str):
    """The datasheet rate of the device named ``name``, or ``None`` for a
    name not in :data:`DATASHEET_BW`: no fraction of it is then printed."""
    return DATASHEET_BW.get(name)


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def sync_for(device):
    """``torch.cuda.synchronize`` for a CUDA device, else a no-op."""
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def timed_loop(step, x, min_diff=0.25, iters0=64, repeats=3, *, clock=time.perf_counter,
               sync=None):
    """Per-step time of ``x = step(x)`` chained in a Python loop,
    differential method, as ``bench.timed_loop``.

    Times loops of ``K`` and ``2K`` steps, each closed by ``sync`` (default:
    ``torch.cuda.synchronize`` for a CUDA ``x``), and returns
    ``((t2 - t1) / K, diagnostics)``: the fixed cost of a loop cancels.
    ``K`` comes from a pilot loop of ``iters0`` steps so that
    ``t2 - t1 >= min_diff`` seconds.  The reading is ``valid`` when the
    difference is at least 20% of ``t2``; otherwise up to three attempts
    re-estimate the per-step cost and double ``min_diff``, and the last
    reading is returned flagged invalid, never clamped.  ``clock`` lets a
    test drive the method."""
    sync = sync or sync_for(x.device)

    def loop(n):
        v = x
        for _ in range(n):
            v = step(v)
        sync()

    loop(iters0)  # warm-up
    t0 = clock()
    loop(iters0)
    per_est = (clock() - t0) / iters0

    for attempt in range(3):
        iters = max(iters0, int(min_diff / max(per_est, 1e-9)) + 1)
        loop(iters)
        loop(2 * iters)
        t1 = t2 = float("inf")
        for _ in range(repeats):
            t0 = clock()
            loop(iters)
            t1 = min(t1, clock() - t0)
            t0 = clock()
            loop(2 * iters)
            t2 = min(t2, clock() - t0)
        diff = t2 - t1
        if diff >= 0.2 * t2 and diff > 0:
            return diff / iters, {"iters": iters, "t1": t1, "t2": t2, "valid": True,
                                  "attempt": attempt}
        per_est = max(per_est / 4, diff / iters if diff > 0 else per_est / 4)
        min_diff *= 2
    return diff / iters, {"iters": iters, "t1": t1, "t2": t2, "valid": False,
                          "attempt": attempt}


def health_gate(device, n=2048):
    """Check that an ``n``-square float32 matmul of ones sums to ``n**3``
    (to 1e-3) before anything is measured; raise ``RuntimeError`` if not."""
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    s = float((a @ a).sum())
    if abs(s - float(n) ** 3) > 1e-3 * float(n) ** 3:
        raise RuntimeError(f"device sick: a {n}^2 matmul of ones summed to {s}, not {n}^3")


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def sm_count(device):
    """The card's SM count, which sets the kernels' grids; ``None`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def cuda_device():
    """``cuda:0``; exit with an error where there is no CUDA device: a probe
    measures the card and has no CPU fallback."""
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def parse_out(description, argv=None):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--out", help="append the JSON line to this file as well")
    return p.parse_args(argv)


def emit(res, out=None):
    """Print ``res`` as one JSON line, and append it to ``out`` if given."""
    line = json.dumps(res)
    print(line)
    sys.stdout.flush()
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    return line
