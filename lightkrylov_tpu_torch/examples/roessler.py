#!/usr/bin/env python
"""Roessler system: chaotic attractor, Newton-Krylov UPO search, OTD modes.

Port of ``examples/roessler.py`` (reference: example/roessler/main.f90 and
roessler_OTD.f90):

1. integrate the chaotic attractor,
2. converge the period-1 unstable periodic orbit by Newton-GMRES shooting
   from the reference initial guess (0, 6.1, 1.3), T0 = 6 (main.f90:87-88),
3. check the OTD instantaneous eigenvalues at the fixed point
   (0.097000856 twice, roessler_OTD.f90:31) and the orbit's Lyapunov
   exponents (0.0, 0.149141556, roessler_OTD.f90:32).

Float64, as the JAX example runs off a TPU.  The RK4 step counts default
to the reference's; each is an option, since eager torch pays a launch or
more per operation on a 3-vector.

Run: python -m lightkrylov_tpu_torch.examples.roessler [--cpu]
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--attractor-steps", type=int, default=60000)
    ap.add_argument("--upo-steps", type=int, default=3000)
    ap.add_argument("--otd-steps", type=int, default=20000)
    ap.add_argument("--floquet-steps", type=int, default=4000)
    args = ap.parse_args(argv)

    import torch

    import lightkrylov_tpu_torch as lt

    lt.set_default_device("cpu" if args.cpu else "cuda")
    dev = lt.default_device()
    lt.logger_setup()
    lt.greetings()

    def vec(values):
        return torch.tensor(values, dtype=torch.float64, device=dev)

    # 1. chaotic attractor (main.f90:66-71)
    p = vec([0.0, -5.0, 0.05])
    p_end = lt.flow(p, vec(300.0), args.attractor_steps)
    print(f"attractor: start {p.cpu().numpy()}, end {p_end.cpu().numpy()}")

    # 2. Newton-Krylov UPO (main.f90:87-108)
    X0 = {"pos": vec([0.0, 6.1, 1.3]), "T": vec(6.0)}
    X, info, meta = lt.newton(lt.upo_system(n_steps=args.upo_steps), X0, rtol=0.0, atol=1e-11,
                              linear_solver_options=lt.GMRESOptions(kdim=4, maxiter=10))
    T = float(X["T"])
    print(f"UPO: pos = {X['pos'].cpu().numpy()}, T = {T:.9f} "
          f"(converged={meta.converged}, {meta.n_iter} Newton steps)")

    # 3. validation anchors
    fp_minus, _ = lt.roessler_fixed_points()
    U0 = np.linalg.qr(np.random.default_rng(0).standard_normal((3, 2)))[0]
    _, _, Lr, _ = lt.otd_evolve(lt.roessler_rhs, vec(fp_minus), vec(U0), 50.0, args.otd_steps)
    w = np.linalg.eigvals(Lr.cpu().numpy())
    print(f"OTD instantaneous eigs at fixed point: {np.sort(w.real)} (ref 0.097000856 x2)")

    mu, LE = lt.floquet_exponents(X["pos"], X["T"], args.floquet_steps)
    print(f"Floquet multipliers: {mu}")
    print(f"Lyapunov exponents:  {LE[:2]} (ref 0.149141556, 0.0)")


if __name__ == "__main__":
    sys.exit(main())
