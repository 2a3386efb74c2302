#!/usr/bin/env python
"""Partitioned-Poisson eigenanalysis, BASELINE config 5, on torch.distributed.

Port of ``examples/poisson_sharded.py``.  Each rank holds a block of rows of
the 2-D Poisson operator (``ShardedPoisson2D``: the stencil kernel on its
rows, a one-row halo from its neighbours), thick-restart Lanczos
(``eighs``) finds the leading eigenvalues, and they are held to the closed
form.  At ``--nx 3162`` this is the 10M-DoF configuration (``--n`` is the
JAX example's name for it; ``torchrun`` takes ``--n`` for an abbreviation
of its own options).

Run, one rank a card over NCCL (two ranks cannot share one card under
NCCL):

    torchrun --nproc-per-node=N -m lightkrylov_tpu_torch.examples.poisson_sharded --nx 3162

on the CPU over gloo, with N processes or without ``torchrun`` in one:

    torchrun --nproc-per-node=4 -m lightkrylov_tpu_torch.examples.poisson_sharded --cpu --nx 256
    python -m lightkrylov_tpu_torch.examples.poisson_sharded --cpu --nx 256
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", "--n", dest="n", type=int, default=1024)
    ap.add_argument("--nev", type=int, default=4)
    ap.add_argument("--kdim", type=int, default=48)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import lightkrylov_tpu_torch as lt

    device = "cpu" if args.cpu else "cuda"
    lt.set_default_device(device)
    lt.comm_setup(device=device)
    lt.logger_setup()  # after comm_setup: only the IO rank logs
    mesh = lt.make_mesh()
    say = print if lt.io_rank() else (lambda *a, **k: None)
    n = args.n - args.n % mesh.size  # divisible rows
    dtype = torch.float64 if args.cpu else torch.float32
    op = lt.ShardedPoisson2D(n, n, mesh=mesh, dtype=dtype)
    say(f"devices={mesh.size}  grid={n}x{n}  dof={n * n / 1e6:.2f}M  "
        f"dtype={str(dtype).split('.')[-1]}")

    rng = np.random.default_rng(0)
    np_dtype = lt.constants.as_numpy_dtype(dtype)
    x0 = lt.distribute(rng.standard_normal((n, n)).astype(np_dtype), mesh)

    # Ritz residuals are absolute; scale the tolerance by the spectral
    # magnitude lambda_max ~ 4/hx^2 + 4/hy^2
    lam_max = 4.0 * (n + 1) ** 2 + 4.0 * (n + 1) ** 2
    tol = (1e-6 if dtype == torch.float32 else 1e-9) * lam_max
    t0 = time.perf_counter()
    evals, evecs, res, info, meta = lt.eighs(op, args.nev, x0=x0, kdim=args.kdim, tolerance=tol,
                                             options=lt.EigsOptions(maxiter=40))
    if not args.cpu:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    exact = np.sort(lt.poisson2d_eigvals(n, n))[::-1]
    say(f"eighs: converged={meta.converged}  {meta.n_iter} Lanczos steps  wall={dt:.1f}s")
    for i, (lam, r) in enumerate(zip(evals, res)):
        rel = abs(lam - exact[i]) / exact[i]
        say(f"  lambda_{i} = {lam:.10e}   exact-rel-err={rel:.2e}   ritz-res={r:.1e}")
    lt.comm_close()


if __name__ == "__main__":
    sys.exit(main())
