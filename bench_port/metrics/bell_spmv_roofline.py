"""The Block-ELL kernel (``bell_spmv``) against its byte roofline, in %:
the bytes one product needs (:func:`product_bytes`) over the datasheet
rate of device memory, over the time of a launch.  The time is CUDA events
around runs of ``CALLS`` launches on the cell's own matrix (41 GB in
float64, far past the 50 MB L2), alternating two inputs, median of
``RUNS``; measured before the traced window, so that no profiler has run in
the process yet."""

import statistics

import torch

from bench_port import harness

RUNS = 10
CALLS = 4


def product_bytes(data, cols, n: int) -> int:
    """Bytes of one ``y = A x`` in the layout as it stands: the stored
    blocks and their block-column indices read once, the input of ``n``
    entries zero-padded to the block grid read once and the output of
    ``nbr * bm`` entries written once."""
    nbr, _, bm, bn = data.shape
    el = data.element_size()
    n_padded = -(-n // bn) * bn
    return data.numel() * el + cols.numel() * cols.element_size() + (n_padded + nbr * bm) * el


def measure(run):
    op = run.state.get("op")
    data, cols = getattr(op, "data", None), getattr(op, "cols", None)
    if data is None or cols is None or not run.cuda:
        return
    bell_spmv = run.lt.ops.spmv.bell_spmv
    n = op.shape[1]
    n_padded = -(-n // data.shape[3]) * data.shape[3]
    xs = [torch.nn.functional.pad(b, (0, n_padded - n)) for b in run.state["pool"][:2]]
    bell_spmv(data, cols, xs[0])
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(CALLS):
            bell_spmv(data, cols, xs[i % len(xs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / CALLS)
    bound_s = product_bytes(data, cols, n) / harness.HBM_BYTES_PER_S
    run.state["bell_spmv_roofline"] = 100.0 * bound_s / statistics.median(times)


def read(run):
    return run.state.get("bell_spmv_roofline")
