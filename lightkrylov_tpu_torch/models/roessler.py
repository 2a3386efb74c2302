"""Roessler system: fixed points, periodic orbits and their Newton-Krylov
systems.

Counterpart of :mod:`lightkrylov_tpu.models.roessler` (reference:
example/roessler/roessler.f90 and src/Utilities/TestUtils.fypp:110-165,
674-690): the Roessler field with ``a = b = 0.2``, ``c = 5.7``
(roessler.f90:22-25), its closed-form fixed points (TestUtils.fypp:674-690)
and the shooting system for an unstable periodic orbit (UPO), whose state is
``{"pos": (3,), "T": ()}``: the residual ``[flow_T(pos) - pos, 0]``
(roessler.f90:240-280) and the Jacobian ``[d flow/d(pos, T)](dx, dT) - dx``
with the phase condition ``<f(pos), dx>`` in the period row
(roessler.f90:282-330).

The flow map is fixed-step RK4 with ``dt = T / n_steps``, written as a
Python loop of tensor operations, so that it is differentiable in both
``pos`` and ``T``: the tangent ``exp(TJ) dx + f(X(T)) dT`` is one exact
``torch.func.jvp`` through the integrator, where the reference integrates a
coupled tangent ODE written by hand.  On a card every operation of the loop
is a kernel launch of a few scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linops import LinearOperator
from ..systems import System

__all__ = [
    "roessler_rhs",
    "roessler_fixed_points",
    "flow",
    "fixed_point_system",
    "upo_system",
    "UPOJacobian",
    "monodromy",
    "floquet_exponents",
    "A_PARAM",
    "B_PARAM",
    "C_PARAM",
]

A_PARAM = 0.2
B_PARAM = 0.2
C_PARAM = 5.7


def roessler_rhs(p):
    """The Roessler field at ``p = (x, y, z)`` (reference: roessler.f90
    ``nonlinear_roessler``).

    The components are taken as length-1 slices, not 0-d tensors: under
    ``torch.func.jvp`` a 0-d float32 tensor combined with a Python float
    gives a float64 tangent (torch 2.11-2.13), which would make the tangent
    of a float32 field float64."""
    x, y, z = p[0:1], p[1:2], p[2:3]
    return torch.cat([-y - z, x + A_PARAM * y, B_PARAM + z * (x - C_PARAM)])


def roessler_fixed_points():
    """The two fixed points as float64 numpy arrays, minus branch first
    (reference: TestUtils.fypp:674-690 ``roessler_analytical_fp``)."""
    d = np.sqrt(C_PARAM**2 - 4 * A_PARAM * B_PARAM)
    fps = []
    for s in (-1.0, +1.0):
        x = (C_PARAM + s * d) / 2.0
        fps.append(np.array([x, -x / A_PARAM, x / A_PARAM]))
    return fps[0], fps[1]


def flow(p0, T, n_steps: int = 1000):
    """The RK4 flow map over the period ``T`` with ``dt = T / n_steps``,
    differentiable in ``(p0, T)``.  The step fractions divide by integers:
    with a Python float a 0-d ``T`` would get a float64 tangent (see
    :func:`roessler_rhs`); the values are those of ``0.5 * dt`` and
    ``dt / 6.0``."""
    dt = T / n_steps
    half, sixth = dt / 2, dt / 6
    p = p0
    for _ in range(n_steps):
        k1 = roessler_rhs(p)
        k2 = roessler_rhs(p + half * k1)
        k3 = roessler_rhs(p + half * k2)
        k4 = roessler_rhs(p + dt * k3)
        p = p + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
    return p


def fixed_point_system() -> System:
    """``F(X) = f(X) = 0``, the fixed-point system (reference:
    TestUtils.fypp:110-165, with the exact derivative for the Jacobian)."""
    return System(roessler_rhs)


class UPOJacobian(LinearOperator):
    """The Jacobian of the UPO shooting residual at ``state = {"pos", "T"}``:
    position rows ``[d flow/d(pos, T)](dx, dT) - dx``, period row
    ``<f(pos), dx>`` (reference: roessler.f90:282-330 ``linear_map``)."""

    def __init__(self, state, n_steps: int = 1000):
        self.state = state
        self.n_steps = n_steps

    def _phi(self, p, t):
        return flow(p, t, self.n_steps)

    def matvec(self, v):
        pos, T = self.state["pos"], self.state["T"]
        dx, dT = v["pos"], v["T"]
        _, dflow = torch.func.jvp(self._phi, (pos, T), (dx, dT))
        # dflow is exp(TJ) dx + f(X(T)) dT
        dT_out = torch.vdot(roessler_rhs(pos), dx).real.to(dT.dtype)
        return {"pos": dflow - dx, "T": dT_out}

    def rmatvec(self, v):
        """The exact adjoint by ``torch.func.vjp``; the reference leaves it
        out (roessler.f90: "we do not need the adjoint of the jacobian")."""
        pos, T = self.state["pos"], self.state["T"]
        dy, dT_in = v["pos"], v["T"]
        _, vjp = torch.func.vjp(self._phi, pos, T)
        gpos, gT = vjp(dy)
        return {"pos": gpos - dy + dT_in * roessler_rhs(pos), "T": gT.to(dT_in.dtype)}


def monodromy(pos, T, n_steps: int = 4000):
    """The monodromy matrix ``d flow_T / d pos`` at a point of a periodic
    orbit (reference: ``monodromy_map``, example/roessler/roessler.f90), by
    ``torch.func.jacfwd`` through the RK4 flow."""
    return torch.func.jacfwd(lambda p: flow(p, T, n_steps))(pos)


def floquet_exponents(pos, T, n_steps: int = 4000):
    """Floquet multipliers, by modulus descending, and Lyapunov exponents
    ``ln|mu| / T`` of the orbit through ``pos`` (anchors: (0.149141556, 0)
    on the period-1 UPO, reference: roessler_OTD.f90:32)."""
    M = monodromy(pos, T, n_steps).detach().cpu().numpy()
    mu = np.linalg.eigvals(M)
    mu = mu[np.argsort(-np.abs(mu))]
    return mu, np.log(np.abs(mu)) / float(T)


def upo_system(n_steps: int = 1000) -> System:
    """The shooting system for unstable periodic orbits: state
    ``{"pos": (3,), "T": ()}``, residual ``{"pos": flow_T(pos) - pos,
    "T": 0}`` (reference: roessler.f90:240-280 ``nonlinear_map``) and the
    :class:`UPOJacobian`."""

    def response(state):
        pos, T = state["pos"], state["T"]
        return {"pos": flow(pos, T, n_steps) - pos, "T": torch.zeros_like(T)}

    def jacobian(state):
        return UPOJacobian(state, n_steps)

    return System(response, jacobian=jacobian)
