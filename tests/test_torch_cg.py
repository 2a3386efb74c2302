"""The port's PCG against the JAX package's on Poisson 32^2 in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import BlockJacobiPoisson, Poisson2D
from lightkrylov_tpu_torch.convert import port_operator, port_options

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

RTOL = lk.constants.rtol(np.float64)


@pytest.mark.parametrize("precond", [False, True], ids=["cg", "pcg"])
def test_cg_on_poisson_matches_jax(precond):
    op_j = Poisson2D(32)
    M_j = BlockJacobiPoisson(op_j) if precond else None
    b = np.random.default_rng(0).standard_normal((32, 32))
    opts = lk.CGOptions(maxiter=200)
    xj, infoj, metaj = lk.cg(op_j, jnp.asarray(b), rtol=1e-10, preconditioner=M_j,
                             options=opts)
    xt, infot, metat = lt.cg(port_operator(op_j), torch.from_numpy(b), rtol=1e-10,
                             preconditioner=port_operator(M_j) if precond else None,
                             options=port_options(opts))
    assert metaj.converged and infot == infoj > 0
    assert (metat.n_iter, metat.n_inner, metat.converged) == \
        (metaj.n_iter, metaj.n_inner, metaj.converged)
    hj = np.asarray(metaj.residuals)
    assert metat.residuals.shape == hj.shape
    assert np.linalg.norm(metat.residuals - hj) <= RTOL * np.linalg.norm(hj)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= RTOL * np.linalg.norm(xj)


def test_cg_maxiter_and_preconditioner_protocol():
    """Non-convergence returns ``-maxiter``; a ``Preconditioner`` receives
    the iteration index and the residual state, as in the JAX solver."""
    seen = []

    class Recording(lt.Preconditioner):
        def apply(self, v, iteration=0, current_residual=0.0, target_residual=0.0):
            seen.append((iteration, float(current_residual), float(target_residual)))
            return v

    op = lt.Poisson2D(16)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 16)))
    x, info, meta = lt.cg(op, b, rtol=1e-12, preconditioner=Recording(),
                          options=lt.CGOptions(maxiter=5))
    assert info == -5 and not meta.converged and len(meta.history) == 5
    assert [s[0] for s in seen] == list(range(6))
    assert seen[0][1] == pytest.approx(float(torch.linalg.norm(b)))
    assert all(s[2] == seen[0][2] > 0 for s in seen)
