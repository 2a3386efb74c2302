"""The port's GMRES against the JAX package's, on the same operator and
right-hand side.

The JAX side runs ``lk.gmres`` on ``PallasPoisson2D(..., interpret=True)``;
the port runs its ``gmres`` on ``convert.port_operator`` of that operator,
which on the CPU computes the stencil's plain version.  In float64 the
iteration counts must be equal, and residual histories and solutions agree
within ``constants.rtol`` (about 3.2e-8) relative to the JAX result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.krylov.gram_schmidt import double_gram_schmidt_step as j_dgs
from lightkrylov_tpu.models import BlockJacobiPoisson as JBlockJacobi
from lightkrylov_tpu.ops.pallas import PallasPoisson2D
from lightkrylov_tpu.utils import timer as jtimer
from lightkrylov_tpu_torch.convert import port_operator, port_options, to_torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

RTOL = lk.constants.rtol(np.float64)


def _assert_same_solve(ref, got):
    (xj, infoj, metaj), (xt, infot, metat) = ref, got
    assert infot == infoj
    assert (metat.n_inner, metat.n_iter, metat.converged) == \
        (metaj.n_inner, metaj.n_iter, metaj.converged)
    hj, ht = np.asarray(metaj.residuals), metat.residuals
    assert ht.shape == hj.shape
    assert np.linalg.norm(ht - hj) <= RTOL * np.linalg.norm(hj)
    xj, xt = np.asarray(xj), xt.numpy()
    assert np.linalg.norm(xt - xj) <= RTOL * np.linalg.norm(xj)


# rtol=1e-4 converges part-way through a later cycle; 1e-9 runs out of
# restarts, so both ends of a cycle are exercised
CASES = {
    "dcgs2": dict(solver="gmres", orth="dcgs2", precond=False, rtol=1e-4),
    "dcgs2-maxiter": dict(solver="gmres", orth="dcgs2", precond=False, rtol=1e-9),
    "cgs2": dict(solver="gmres", orth="cgs2", precond=False, rtol=1e-4),
    "dcgs2-blockjacobi": dict(solver="gmres", orth="dcgs2", precond=True, rtol=1e-4),
    "fgmres-blockjacobi": dict(solver="fgmres", orth="dcgs2", precond=True, rtol=1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gmres_on_poisson_matches_jax(case):
    c = CASES[case]
    op_j = PallasPoisson2D(24, 32, dtype=jnp.float64, tile=16, interpret=True)
    b = np.random.default_rng(0).standard_normal((32, 24))
    opts = lk.GMRESOptions(kdim=10, maxiter=12, orthogonalization=c["orth"])
    M_j = JBlockJacobi(lk.models.Poisson2D(24, 32)) if c["precond"] else None

    jtimer.reset_counters()
    lt.timer.reset_counters()
    ref = getattr(lk, c["solver"])(op_j, jnp.asarray(b), rtol=c["rtol"],
                                   preconditioner=M_j, options=opts)
    op_t = port_operator(op_j)
    got = getattr(lt, c["solver"])(
        op_t, torch.from_numpy(b), rtol=c["rtol"],
        preconditioner=port_operator(M_j) if M_j is not None else None,
        options=port_options(opts))
    _assert_same_solve(ref, got)
    assert ref[2].n_iter > 1  # restarts were exercised
    assert ref[2].converged == (c["rtol"] > 1e-6)
    # the same executed-application accounting, operator and preconditioner
    assert lt.timer.get_counter("CudaPoisson2D.matvec") == \
        jtimer.get_counter("PallasPoisson2D.matvec")
    if M_j is not None:
        assert lt.timer.get_counter("BlockJacobiPoisson.matvec") == \
            jtimer.get_counter("BlockJacobiPoisson.matvec")
    # one host read per inner iteration plus a few per cycle
    assert lt.timer.get_counter("host_reads") <= got[2].n_inner + 3 * got[2].n_iter + 2


@pytest.mark.parametrize("orth", ["dcgs2", "cgs2"])
def test_gmres_complex_dense_matches_jax(orth):
    n = 40
    rng = np.random.default_rng(1)
    A = 3.0 * np.eye(n) + (rng.standard_normal((n, n))
                           + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    opts = lk.GMRESOptions(kdim=8, maxiter=20, orthogonalization=orth)
    op_j = lk.DenseOperator(jnp.asarray(A))
    ref = lk.gmres(op_j, jnp.asarray(b), rtol=1e-10, options=opts)
    got = lt.gmres(port_operator(op_j), torch.from_numpy(b), rtol=1e-10,
                   options=port_options(opts))
    assert got[0].dtype == torch.complex128
    _assert_same_solve(ref, got)


def test_gmres_transpose_and_early_exit():
    """``transpose=True`` solves with A^H; an exact x0 stops at once."""
    n = 30
    rng = np.random.default_rng(2)
    A = 4.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    x, info, meta = lt.gmres(torch.from_numpy(A), torch.from_numpy(b), rtol=1e-12,
                             transpose=True)
    assert meta.converged and info > 0
    assert np.linalg.norm(A.T @ x.numpy() - b) <= 1e-10 * np.linalg.norm(b)
    xj, infoj, metaj = lk.gmres(jnp.asarray(A), jnp.asarray(b), x0=jnp.asarray(
        np.linalg.solve(A, b)))
    xt, infot, metat = lt.gmres(torch.from_numpy(A), torch.from_numpy(b),
                                x0=torch.from_numpy(np.linalg.solve(A, b)))
    assert (infot, metat.n_inner, metat.n_iter) == (infoj, metaj.n_inner, metaj.n_iter)


def _basis_with_zero_tail(rng, n, live, total):
    Q, _ = np.linalg.qr(rng.standard_normal((n, live)))
    X = np.zeros((total, n))
    X[:live] = Q.T
    return X


def test_cgs2_info_matches_jax():
    """The post-CGS2 vanished-column flag: 1 for a vector in span(X); for a
    block, the 1-based index of the *first* vanished column."""
    rng = np.random.default_rng(3)
    X = _basis_with_zero_tail(rng, 20, 4, 6)   # two unfilled columns
    in_span = X[:4].T @ rng.standard_normal(4)
    free = rng.standard_normal(20)
    cases = [free, in_span,
             np.stack([free, in_span, in_span]),
             np.stack([free, rng.standard_normal(20)])]
    for y in cases:
        yj, pj, ij = j_dgs(jnp.asarray(y), jnp.asarray(X), return_info=True)
        yt, pt, it = lt.double_gram_schmidt_step(
            torch.from_numpy(y), torch.from_numpy(X), return_info=True)
        assert it.dtype == torch.int32 and int(it) == int(ij)
        assert np.allclose(pt.numpy(), np.asarray(pj), rtol=RTOL, atol=1e-12)
        assert np.allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=1e-12)
    assert [int(lt.double_gram_schmidt_step(torch.from_numpy(y), torch.from_numpy(X),
                                            return_info=True)[2]) for y in cases] == [0, 1, 2, 0]


def test_to_torch_keeps_dtypes():
    tree = {"a": np.arange(3, dtype=np.int32), "b": [jnp.ones(2, jnp.complex64)],
            "c": 1.5}
    out = to_torch(tree)
    assert out["a"].dtype == torch.int32
    assert out["b"][0].dtype == torch.complex64
    assert out["c"] == 1.5
