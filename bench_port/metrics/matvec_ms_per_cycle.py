"""Milliseconds of device time a cycle in the operator: the CUDA event time
of the program's ``gmres.matvec`` spans (each application with its
preconditioner, the start residual's and the check's; on several ranks the
halo exchange inside it), summed over a cycle and averaged over the
window's cycles after the traced ones, on rank 0.  The spans are on in
traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.device_ms_per_solve(run, "gmres", "gmres.matvec")
