"""Milliseconds of device time a solve in the projected problem: the CUDA
event time of the program's ``eigs.check`` spans (each device check of
the projected Hessenberg: the Schur kernel, a fill and the Ritz kernel),
summed over an ``eigs`` call and averaged over the window's calls after
the traced one.  The spans are on in traced runs only (``measure``); a
program without them gives no reading."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "eigs", "eigs.check")
