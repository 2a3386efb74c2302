"""Nonzeros the sparse product applies a second of its device time, in
Gnnz/s: the program's counter ``bell.nnz_applied`` (the matrix's ``nnz``
for every vector a launch multiplies), zeroed before the window, over the
CUDA event time of every ``bell.spmv`` span of the window's cycles.  It
counts true nonzeros, not stored values, so it does not depend on the
layout.  The spans are on in traced runs only (``measure``); a program
without the spans or the counter gives no reading."""

from bench_port import spanread

COUNTERS = ("bell.nnz_applied",)
measure = spanread.enable


def read(run):
    nnz = run.counters.get("bell.nnz_applied")
    sv = spanread.solves(run, "gmres")
    if not nnz or sv is None:
        return None
    ms = [s.device_ms for _, d in sv for s in d if s.name == "bell.spmv"]
    if not ms or any(t is None for t in ms) or sum(ms) <= 0:
        return None
    return nnz / (sum(ms) * 1e-3) * 1e-9
