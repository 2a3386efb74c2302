#!/usr/bin/env python
"""Linearized Ginzburg-Landau: leading eigenpairs of the exponential
propagator by time-stepper Arnoldi and Krylov-Schur.

Port of ``examples/ginzburg_landau.py``, the reference's flagship example
(reference: example/ginzburg_landau/main.f90): nx = 512, L = 200, the time
horizon tau, direct and adjoint spectra, the spectrum saved as ``.npy``
(``save_eigenspectrum``).  Complex128, as the JAX example runs off a TPU.

Run: python -m lightkrylov_tpu_torch.examples.ginzburg_landau [--nx 512] [--tau 1.0] [--cpu]
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--kdim", type=int, default=32)
    ap.add_argument("--n-steps", type=int, default=2000)
    ap.add_argument("--out", default="gl_spectrum_out.npy")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import lightkrylov_tpu_torch as lt

    lt.set_default_device("cpu" if args.cpu else "cuda")
    lt.logger_setup()
    lt.greetings()
    lt.set_timing(True)

    gl = lt.GinzburgLandau(args.nx, dtype=torch.complex128)
    prop = lt.GLPropagator(gl, tau=args.tau, n_steps=args.n_steps)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal(args.nx)
                          + 1j * rng.standard_normal(args.nx)).to(lt.default_device())

    with lt.timed("gl_direct_eigs"):
        evals, evecs, res, info, meta = lt.eigs(
            prop, args.nev, x0=x0, kdim=args.kdim, tolerance=1e-8,
            options=lt.EigsOptions(maxiter=30))
    # map exp-eigenvalues back to generator eigenvalues by Rayleigh quotients
    lam_A = []
    for i in range(len(evals)):
        v = lt.get_column(evecs, i)
        lam_A.append(complex(lt.dot(v, gl.matvec(v)) / lt.dot(v, v)))
    print(f"\ndirect spectrum (converged={meta.converged}, n_matvec~{meta.n_iter}):")
    for lam, r in zip(lam_A, res):
        print(f"  lambda = {lam.real:+.8f} {lam.imag:+.8f}i   (ritz res {r:.1e})")
    lt.save_eigenspectrum(np.asarray(lam_A), np.asarray(res), args.out)

    with lt.timed("gl_adjoint_eigs"):
        evals_a, _, res_a, _, meta_a = lt.eigs(
            prop, args.nev, x0=x0, kdim=args.kdim, tolerance=1e-8,
            transpose=True, options=lt.EigsOptions(maxiter=30))
    print(f"\nadjoint propagator converged={meta_a.converged}")
    lt.global_watch.print_summary()
    lt.set_timing(False)


if __name__ == "__main__":
    sys.exit(main())
