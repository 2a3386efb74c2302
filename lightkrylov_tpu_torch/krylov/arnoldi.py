"""Shared step accounting of the Krylov factorizations.

Counterpart of the part of :mod:`lightkrylov_tpu.krylov.arnoldi` that
:mod:`.lanczos` uses: ``_count_steps``.  The Arnoldi factorization itself
is ROADMAP M8.
"""

from __future__ import annotations

from ..utils.timer import count_applications, host_read, time_lightkrylov


def _count_steps(A, info, kstart, kend, n_per_step, kind):
    """Execution-accurate matvec counting for a standalone factorization
    call (reference brackets arnoldi itself: arnoldi.fypp:18,75).  It reads
    ``info`` to the host, so it runs only when ``time_lightkrylov()`` is
    on, and is free when instrumentation is off (as in the JAX package)."""
    if not time_lightkrylov():
        return
    i = int(host_read(info))
    stop = abs(i) if i != 0 else int(kend)
    count_applications(A, max(0, stop - int(kstart) + 1) * n_per_step, kind)
