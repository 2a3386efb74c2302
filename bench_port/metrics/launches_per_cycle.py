"""Kernel launches a cycle: the host's launch calls in the profiler's trace
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``) that
start inside the program's ``gmres`` spans of the traced cycles, over those
cycles, on rank 0.  The spans are on in traced runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.launches_per_solve(run, "gmres")
