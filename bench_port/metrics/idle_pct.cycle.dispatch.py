"""The part of ``idle_pct.cycle`` that host dispatch explains, in %: the
share of the traced window in which the device is idle while the host is
inside a ``gmres`` span of the program and outside its ``host_read`` spans
(so not waiting for the device), on rank 0.  The spans are on in traced
runs only (``measure``)."""

from bench_port import spanread

measure = spanread.enable


def read(run):
    return spanread.idle_dispatch_pct(run, "gmres")
