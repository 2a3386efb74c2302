"""One restart cycle of GMRES(k) from ``x0 = 0``: Arnoldi with classical
Gram-Schmidt applied twice, then the small least-squares problem in
float64 by NumPy.  In exact arithmetic this is the iterate that any
GMRES(k) implementation returns after its first cycle: the minimiser of
``||b - A x||`` over the Krylov space of ``b`` of dimension ``k``."""

import numpy as np
import torch


def gmres_cycle(matvec, b: torch.Tensor, kdim: int, dtype=torch.float64, rounding=None):
    """``(x, residual_estimate)`` after one GMRES(``kdim``) cycle of
    ``A x = b``.  The basis, the operator and the products run in
    ``dtype``; ``rounding`` (see :mod:`.precision`) rounds the operands of
    every product with the basis, as a lower-precision control does."""
    shape = b.shape
    rnd = rounding or (lambda t: t)
    b = b.to(dtype).reshape(-1)
    n = b.numel()
    V = torch.zeros((kdim + 1, n), dtype=dtype, device=b.device)
    H = np.zeros((kdim + 1, kdim))
    beta = float(torch.linalg.vector_norm(b))
    V[0] = b / beta
    k = kdim
    for j in range(kdim):
        w = matvec(V[j].reshape(shape)).to(dtype).reshape(-1)
        for _ in range(2):
            Q = rnd(V[: j + 1])
            h = Q @ rnd(w)
            w = w - rnd(h) @ Q
            H[: j + 1, j] += h.double().cpu().numpy()
        H[j + 1, j] = float(torch.linalg.vector_norm(w))
        if H[j + 1, j] == 0.0:
            k = j + 1
            break
        V[j + 1] = w / H[j + 1, j]
    e1 = np.zeros(k + 1)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H[: k + 1, :k], e1, rcond=None)
    res = float(np.linalg.norm(e1 - H[: k + 1, :k] @ y))
    yt = torch.as_tensor(y, dtype=dtype, device=b.device)
    x = rnd(yt) @ rnd(V[:k])
    return x.reshape(shape), res
