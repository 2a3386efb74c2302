"""Linearized complex Ginzburg-Landau operator and its time-stepper
propagator.

Counterpart of :mod:`lightkrylov_tpu.models.ginzburg_landau`, the
reference's flagship eigenanalysis example (reference:
example/ginzburg_landau/Ginzburg_Landau.f90): the linearized CGL equation
``du/dt = -nu u_x + gamma u_xx + mu(x) u`` on ``nx`` interior points of
``[-L/2, L/2]`` with homogeneous Dirichlet BCs, ``nu = 2 + 0.2i``,
``gamma = 1 - 1i``, ``mu(x) = (mu_0 - c_mu^2) + (mu_2/2) x^2``, ``mu_0 =
0.38``, ``c_mu = 0.2``, ``mu_2 = -0.01``, ``L = 200``, ``nx = 512``
(Ginzburg_Landau.f90:24-33,96-97), with centred differences
(:127-137).  The eigs set-up of the reference is ``tau = 0.01``,
``nev = 8``, ``kdim = 16`` (main.f90:20-27,68).

:class:`GinzburgLandau` works in complex arithmetic, which CUDA tensors
have.  :class:`GinzburgLandauReal` carries ``u = a + ib`` as a real
``(2, nx)`` state; the JAX package needed it because its TPU runtime
compiled no complex computation, and it stays here for parity with that
record.  :class:`GLPropagator` is the time-stepper matvec ``exp(tau A)``
by RK4, a plain Python loop of ``n_steps`` steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import as_torch_dtype, resolve_device
from ..linops import LinearOperator

__all__ = ["GinzburgLandau", "GinzburgLandauReal", "GLPropagator",
           "gl_analytic_eigvals", "NU", "GAMMA", "MU0", "C_MU", "MU2"]

NU = 2.0 + 0.2j
GAMMA = 1.0 - 1.0j
MU0 = 0.38
C_MU = 0.2
MU2 = -0.01


def _mu(nx, L):
    """``mu`` at the interior nodes (Ginzburg_Landau.f90:96-97)."""
    x = np.linspace(-L / 2, L / 2, nx + 2)[1:-1]
    return (MU0 - C_MU**2) + (MU2 / 2.0) * x**2


def _derivatives(u, dx):
    """Centred ``(u_x, u_xx)`` along the last axis, with zero values beyond
    both ends."""
    zero = torch.zeros_like(u[..., :1])
    um = torch.cat([zero, u[..., :-1]], -1)  # u_{i-1}
    up = torch.cat([u[..., 1:], zero], -1)   # u_{i+1}
    return (up - um) / (2.0 * dx), (up - 2.0 * u + um) / dx**2


def _rhs(u, mu, dx, c1, c2):
    """``c1 u_x + c2 u_xx + mu u``."""
    ux, uxx = _derivatives(u, dx)
    return c1 * ux + c2 * uxx + mu * u


class GinzburgLandau(LinearOperator):
    """Linearized CGL operator on a complex state of shape ``(nx,)``;
    ``mu`` is a tensor of ``dtype`` on ``device``."""

    def __init__(self, nx: int = 512, L: float = 200.0, dtype=torch.complex128, device=None):
        self.nx = nx
        self.L = float(L)
        self.dtype_ = as_torch_dtype(dtype)
        self.mu = torch.as_tensor(_mu(nx, self.L), dtype=self.dtype_,
                                  device=resolve_device(device))

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        return torch.zeros((self.nx,), dtype=self.dtype_, device=self.mu.device)

    def matvec(self, u):
        """(Ginzburg_Landau.f90:127-137 ``rhs``)."""
        return _rhs(u, self.mu, self.dx, -NU, GAMMA)

    def rmatvec(self, u):
        """Adjoint: conjugate coefficients and the convection sign flipped
        (Ginzburg_Landau.f90:171-181 ``adjoint_rhs``)."""
        return _rhs(u, self.mu, self.dx, np.conj(NU), np.conj(GAMMA))

    def dense(self):
        """The dense complex128 matrix of the stored coefficients, as numpy
        (small ``nx`` only)."""
        n, dx = self.nx, self.dx
        mu = self.mu.cpu().numpy().astype(complex)
        A = np.diag(-2.0 * GAMMA / dx**2 + mu)
        i = np.arange(n - 1)
        A[i + 1, i] = NU / (2 * dx) + GAMMA / dx**2
        A[i, i + 1] = -NU / (2 * dx) + GAMMA / dx**2
        return A


def _realified_rhs(u, mu, dx, c1, c2):
    """:func:`_rhs` of the complex state ``u[0] + i u[1]`` in real
    arithmetic."""
    ux, uxx = _derivatives(u, dx)
    re = ((c1.real * ux[0] - c1.imag * ux[1]) + (c2.real * uxx[0] - c2.imag * uxx[1])
          + mu * u[0])
    im = ((c1.imag * ux[0] + c1.real * ux[1]) + (c2.imag * uxx[0] + c2.real * uxx[1])
          + mu * u[1])
    return torch.stack([re, im])


class GinzburgLandauReal(LinearOperator):
    """The REALIFIED CGL operator: the complex state ``u = a + ib`` is the
    real ``(2, nx)`` array ``[a; b]`` and the complex coefficients are
    expanded into real arithmetic.  Its spectrum is ``{lambda} ∪
    {conj(lambda)}``, so ``nev`` complex eigenvalues are ``2 nev`` real-
    operator Ritz values.  ``rmatvec`` is the realified complex adjoint
    ``R(A^H) = R(A)^T``, which the JAX package gets by autodiff transpose.
    Same grid and parameters as :class:`GinzburgLandau`."""

    def __init__(self, nx: int = 512, L: float = 200.0, dtype=torch.float32, device=None):
        self.nx = nx
        self.L = float(L)
        self.dtype_ = as_torch_dtype(dtype)
        self.mu = torch.as_tensor(_mu(nx, self.L), dtype=self.dtype_,
                                  device=resolve_device(device))

    @property
    def dx(self):
        return self.L / (self.nx + 1)

    def template(self):
        return torch.zeros((2, self.nx), dtype=self.dtype_, device=self.mu.device)

    def matvec(self, u):
        """Realified rhs: ``u[0]`` the real part, ``u[1]`` the imaginary."""
        return _realified_rhs(u, self.mu, self.dx, -NU, GAMMA)

    def rmatvec(self, u):
        return _realified_rhs(u, self.mu, self.dx, np.conj(NU), np.conj(GAMMA))

    def dense(self):
        """Real ``2nx``-square dense form, as numpy (small ``nx`` only)."""
        Ac = GinzburgLandau(self.nx, self.L).dense()
        return np.block([[Ac.real, -Ac.imag], [Ac.imag, Ac.real]])


def gl_analytic_eigvals(n_modes: int = 8):
    """Branch spectrum of the continuous operator (a loose oracle; the
    discrete operator converges to it as ``nx`` grows)."""
    h = np.sqrt(-2.0 * MU2 * GAMMA)
    n = np.arange(n_modes)
    return (MU0 - C_MU**2) - NU**2 / (4.0 * GAMMA) - (n + 0.5) * h


class GLPropagator(LinearOperator):
    """Exponential propagator ``exp(tau A)`` by ``n_steps`` RK4 steps of
    the linear rhs, the reference's time-stepper matvec
    (Ginzburg_Landau.f90:259-293 ``direct_solver``/``adjoint_solver``)."""

    def __init__(self, A, tau: float = 0.01, n_steps: int = 10):
        self.A = A
        self.tau = float(tau)
        self.n_steps = n_steps

    def _integrate(self, u, rhs):
        dt = self.tau / self.n_steps
        for _ in range(self.n_steps):
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt * k1)
            k3 = rhs(u + 0.5 * dt * k2)
            k4 = rhs(u + dt * k3)
            u = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return u

    def matvec(self, x):
        return self._integrate(x, self.A.matvec)

    def rmatvec(self, y):
        return self._integrate(y, self.A.rmatvec)
