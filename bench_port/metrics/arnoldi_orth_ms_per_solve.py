"""Milliseconds of device time a solve in the Arnoldi steps' basis work:
the CUDA event time of the program's ``arnoldi.orth`` spans (each step's
CGS2 projection against the filled basis, the norm and the column writes),
summed over an ``eigs`` call and averaged over the window's calls after the
traced one.  The spans are on in traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "eigs", "arnoldi.orth")
