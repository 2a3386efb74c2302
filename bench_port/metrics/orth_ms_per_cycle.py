"""Milliseconds of device time a cycle in the factorisation's basis work:
the CUDA event time of the program's ``gmres.orth`` spans (each Arnoldi
step's DCGS2 measurement through its rank-2 update and column writes),
summed over a cycle and averaged over the window's cycles after the traced
ones, on rank 0.  The spans are on in traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "gmres", "gmres.orth")
