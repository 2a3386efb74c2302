"""The convection-diffusion operator ``-eps Delta u + cx u_x + cy u_y`` on
the unit square with homogeneous Dirichlet boundaries: the 5-point
diffusion and centred differences for the convection, ``nx`` by ``ny``
interior points, spacing ``h = 1 / (n + 1)`` in each direction, a grid
stored as ``(ny, nx)`` (x along a row).  Applied matrix-free, by padding
the grid with its zero boundary and slicing the neighbours out."""

import torch


def apply(u: torch.Tensor, nx: int, ny: int, eps: float, cx: float, cy: float) -> torch.Tensor:
    """``A u`` of the ``(ny, nx)`` grid ``u``, in ``u``'s dtype."""
    if u.shape != (ny, nx):
        raise ValueError(f"grid {tuple(u.shape)} is not ({ny}, {nx})")
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    p = torch.nn.functional.pad(u, (1, 1, 1, 1))
    west, east = p[1:-1, :-2], p[1:-1, 2:]
    south, north = p[:-2, 1:-1], p[2:, 1:-1]
    diffusion = (2.0 / hx**2 + 2.0 / hy**2) * u - (west + east) / hx**2 \
        - (south + north) / hy**2
    convection = cx * (east - west) / (2.0 * hx) + cy * (north - south) / (2.0 * hy)
    return eps * diffusion + convection
