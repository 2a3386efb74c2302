"""Milliseconds of device time a solve in the vector layer's passes: the
CUDA event time of the program's ``cg.update`` spans (each CG iteration's
dots, norm and updates, all but the operator), summed over a solve and
averaged over the window's solves after the traced one.  The spans are on
in traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "cg", "cg.update")
