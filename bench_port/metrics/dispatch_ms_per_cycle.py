"""Milliseconds of host time a cycle spent other than waiting for the
device: the program's ``gmres`` span less its ``host_read`` spans, by the
host clock, averaged over the window's cycles after the traced ones, on
rank 0.  Beside ``busy_ms_per_cycle`` it says whether the host dispatches a
cycle faster than the device runs it.  The spans are on in traced runs only
(``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.dispatch_ms_per_solve(run, "gmres")
