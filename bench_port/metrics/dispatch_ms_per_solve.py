"""Milliseconds of host time a CG solve spent other than waiting for the
device: the program's ``cg`` span less its ``host_read`` spans, by the host
clock, averaged over the window's solves after the traced one.  The spans
are on in traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.dispatch_ms_per_solve(run, "cg")
