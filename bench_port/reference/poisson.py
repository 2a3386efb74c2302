"""The negative 5-point Laplacian on the unit square with homogeneous
Dirichlet boundaries: ``nx`` by ``ny`` interior points, spacing
``h = 1 / (n + 1)`` in each direction, a grid stored as ``(ny, nx)``."""

import torch


def laplacian(u: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """``-Delta u`` of the ``(ny, nx)`` grid ``u``, in ``u``'s dtype."""
    if u.shape != (ny, nx):
        raise ValueError(f"grid {tuple(u.shape)} is not ({ny}, {nx})")
    cx, cy = float(nx + 1) ** 2, float(ny + 1) ** 2
    out = (2.0 * (cx + cy)) * u
    out[:, 1:] -= cx * u[:, :-1]
    out[:, :-1] -= cx * u[:, 1:]
    out[1:, :] -= cy * u[:-1, :]
    out[:-1, :] -= cy * u[1:, :]
    return out


def relative_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``||a - b|| / ||b||`` in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def relative_residual(x: torch.Tensor, b: torch.Tensor, nx: int, ny: int) -> float:
    """``||b - A x|| / ||b||`` in float64."""
    b = b.double()
    r = b - laplacian(x.double(), nx, ny)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
