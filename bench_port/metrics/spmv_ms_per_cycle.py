"""Milliseconds of device time a cycle in the sparse product: the CUDA
event time of the program's ``bell.spmv`` spans (each launch of the
Block-ELL kernel by ``BellOperator``, inside ``gmres.matvec``), summed over
a cycle and averaged over the window's cycles after the traced ones.  The
spans are on in traced runs only (``measure``); a program without them
gives no reading."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "gmres", "bell.spmv")
