"""The cell's operator ``matvec`` against its byte roofline, in %: the
bytes the product needs (the input read once and the output written once)
over the datasheet rate of device memory, over the time of a call.  The
time is CUDA events around runs of calls rotating over enough inputs that
none is still in the 50 MB L2 (as ``chip_smoke.py``'s cold stencil timing
does), median of ``RUNS``; measured before the traced window, so that no
profiler has run in the process yet."""

import statistics

import torch

from bench_port import harness

L2_BYTES = 50 * 2**20
RUNS = 10


def measure(run):
    op = run.state.get("op")
    if op is None or not run.cuda:
        return
    u0 = run.state["pool"][0]
    nbytes = u0.numel() * u0.element_size()
    nbuf = max(1, -(-4 * L2_BYTES // nbytes))
    fields = [torch.randn(u0.shape, generator=run.generator(4, i), device=run.device,
                          dtype=u0.dtype) for i in range(nbuf)]
    per_run = 2 * nbuf
    for f in fields:
        op.matvec(f)
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_run):
            op.matvec(fields[i % nbuf])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / per_run)
    bound_s = 2 * nbytes / harness.HBM_BYTES_PER_S
    run.state["stencil_matvec_roofline"] = 100.0 * bound_s / statistics.median(times)


def read(run):
    return run.state.get("stencil_matvec_roofline")
