"""Milliseconds of device time a solve in the restarts: the CUDA event
time of the program's ``eigs.restart`` spans (on the default selector the
exact-shift IRAM filter's kernels and the rotation of the basis by its
transform), summed over an ``eigs`` call and averaged over the window's
calls after the traced one.  The spans are on in traced runs only
(``measure``); a program without them gives no reading."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "eigs", "eigs.restart")
