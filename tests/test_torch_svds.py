"""The port's Golub-Kahan bidiagonalization and ``svds`` against the JAX
package's, on the same operators and start vectors.

The JAX ``svds`` takes its host projected path on the CPU ("auto" is host
off a TPU), which is the path the port implements, so the two agree in
method: ``info``, ``n_iter`` and the convergence flag are equal.  Tolerances,
all in float64 or complex128: the bidiagonal ``B`` within 1e-12 of its
largest entry, the factorization identity ``A V = U B`` within 1e-12 of
``|A|``, singular values within 1e-9 of the largest (against JAX's and
numpy's dense SVD), residual histories within 1e-9 of the largest singular
value, and singular vectors up to a phase (``|<u_jax, u_port>| = 1`` within
1e-6).  Through ``PallasPoisson2D`` and a Block-ELL operator the port runs
``CudaPoisson2D`` and ``BellOperator``, whose plain versions stand in for
the CUDA kernels K1 and K3 on the CPU; the JAX side runs the Pallas kernels
in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.krylov.bidiag import bidiagonalization as j_bidiag
from lightkrylov_tpu.krylov.bidiag import initialize_bidiag as j_init
from lightkrylov_tpu.models import Poisson2D as JPoisson
from lightkrylov_tpu.ops.pallas import BellOperator as JBellOperator
from lightkrylov_tpu.ops.pallas import PallasPoisson2D
from lightkrylov_tpu.ops.pallas import bell_from_scipy as j_bell_from_scipy
from lightkrylov_tpu.utils import timer as jtimer
from lightkrylov_tpu_torch.convert import port_operator, port_options
from lightkrylov_tpu_torch.utils.logger import LightKrylovError

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


B_TOL = 1e-12
SV_TOL = 1e-9
N = 60


def _draw(shape, seed, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


def _geometric(m, n, seed, complex_=False):
    """An m x n matrix with singular values 3 * 0.8^i, restart-friendly
    (tests/test_eigensolvers.py:235-249)."""
    rng = np.random.default_rng(seed)
    sv = 3.0 * 0.8 ** np.arange(n)
    Um, _ = np.linalg.qr(rng.standard_normal((m, n)))
    Vm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Um * sv) @ Vm.T
    if complex_:
        A = A.astype(complex) * np.exp(1j * rng.uniform(0, 2 * np.pi, n))[None, :]
    return A, sv


# -- bidiagonalization --------------------------------------------------------

def _bidiag_case(case):
    """(JAX operator, dense matrix, u0, v template)."""
    if case == "poisson-16":
        op = JPoisson(16, dtype=jnp.float64)
        return op, lt.Poisson2D(16).dense().numpy(), _draw((16, 16), 1), np.zeros((16, 16))
    complex_ = case == "dense-c128"
    A = _draw((N, N // 2), 2, complex_)
    dt = A.dtype
    return lk.DenseOperator(jnp.asarray(A)), A, _draw(N, 3, complex_), np.zeros(N // 2, dt)


def _bidiag_pair(op_j, u0, v_t, kdim, sweeps):
    Uj, Vj, Bj = j_init(jnp.asarray(u0), jnp.asarray(v_t), kdim)
    Ut, Vt, Bt = lt.initialize_bidiag(torch.from_numpy(u0), torch.from_numpy(v_t), kdim)
    op_t = port_operator(op_j)
    for k0, k1 in sweeps:
        Uj, Vj, Bj, ij = j_bidiag(op_j, Uj, Vj, Bj, kstart=k0, kend=k1)
        Ut, Vt, Bt, it = lt.bidiagonalization(op_t, Ut, Vt, Bt, kstart=k0, kend=k1)
        assert it.dtype == torch.int32 and int(it) == int(ij)
    return (Uj, Vj, Bj, ij), (Ut, Vt, Bt, it)


@pytest.mark.parametrize("case", ["dense-f64", "dense-c128", "poisson-16"])
@pytest.mark.parametrize("sweeps", [[(1, 12)], [(1, 5), (6, 12)]], ids=["one", "two"])
def test_bidiagonalization_matches_jax(case, sweeps):
    op_j, A, u0, v_t = _bidiag_case(case)
    (Uj, Vj, Bj, ij), (Ut, Vt, Bt, it) = _bidiag_pair(op_j, u0, v_t, 12, sweeps)
    assert int(it) == 0
    Bj = np.asarray(Bj)
    assert Bt.dtype == lt.constants.as_torch_dtype(Bj.dtype)
    assert np.abs(Bt.numpy() - Bj).max() <= B_TOL * np.abs(Bj).max()
    # A V_k = U_{k+1} B_k, with U and V orthonormal
    U, V = (t.numpy().reshape(t.shape[0], -1) for t in (Ut, Vt))
    B = Bt.numpy()
    assert np.linalg.norm(A @ V.T - U.T @ B) <= B_TOL * np.linalg.norm(A)
    for Q in (U, V):
        assert np.abs(Q.conj() @ Q.T - np.eye(Q.shape[0])).max() < 1e-12


def test_bidiagonalization_breakdown_matches_jax():
    """u0 in the span of three singular vectors: both packages break down
    at step 3 with info = 3, and the later columns stay zero."""
    d = np.linspace(1.0, 30.0, 30)
    u0 = np.zeros(30)
    u0[[2, 11, 20]] = [1.0, -2.0, 0.5]
    op_j = lk.DenseOperator(jnp.asarray(np.diag(d)))
    (Uj, Vj, Bj, ij), (Ut, Vt, Bt, it) = _bidiag_pair(op_j, u0, np.zeros(30), 8, [(1, 8)])
    assert int(ij) == int(it) == 3
    assert np.abs(Bt.numpy() - np.asarray(Bj)).max() <= B_TOL * 30
    assert float(Bt[3, 2]) == 0.0 and not Ut[4:].any() and not Vt[3:].any()
    # svds stops at the invariant subspace with exact residuals
    U, S, V, res, info, meta = lt.svds(port_operator(op_j), 2, u0=torch.from_numpy(u0), kdim=8)
    assert info == 2 and meta.converged and meta.n_iter == 3
    assert np.allclose(S, [d[20], d[11]]) and not res.any()


class _NanOp(lt.LinearOperator):
    def matvec(self, x):
        return x * float("nan")

    def rmatvec(self, y):
        return y * float("nan")


def test_bidiagonalization_nan_is_fatal():
    """(tests/test_krylov.py:333-353)."""
    x0 = torch.from_numpy(_draw(16, 1))
    U, V, B = lt.initialize_bidiag(x0, x0, 4)
    _, _, _, info = lt.bidiagonalization(_NanOp(), U, V, B)
    assert int(info) == -1
    with pytest.raises(LightKrylovError, match="bidiagonalization"):
        lt.svds(_NanOp(), 2, u0=x0, kdim=4)


def test_bidiagonalization_counts_both_applications():
    """One matvec and one rmatvec per step, with timing on."""
    op = lt.DenseOperator(torch.from_numpy(_draw((N, 20), 4)))
    U, V, B = lt.initialize_bidiag(torch.from_numpy(_draw(N, 5)),
                                   torch.zeros(20, dtype=torch.float64), 10)
    lt.timer.reset_counters()
    lt.set_timing(True)
    try:
        lt.bidiagonalization(op, U, V, B, kstart=1, kend=7)
    finally:
        lt.set_timing(False)
    assert lt.timer.get_counter("DenseOperator.matvec") == 7
    assert lt.timer.get_counter("DenseOperator.rmatvec") == 7


# -- svds ---------------------------------------------------------------------

def _poisson_pallas():
    return PallasPoisson2D(16, 16, dtype=jnp.float64, tile=8, interpret=True)


def _convdiff_bell():
    dense = lt.ConvectionDiffusion2D(16).dense().numpy()
    return JBellOperator(j_bell_from_scipy(sp.csr_matrix(dense), bm=8, bn=128, dtype=np.float64),
                         interpret=True)


SVDS_CASES = {
    # a random rectangular operator, no restart needed
    "rect-f64": dict(A=lambda: _draw((N, N // 2), 7), nsv=4, kdim=24, tolerance=1e-10),
    "rect-c128": dict(A=lambda: _draw((N, N // 2), 8, True), nsv=4, kdim=24, tolerance=1e-10),
    # thick restarts (tests/test_eigensolvers.py:235-262)
    "restart-f64": dict(A=lambda: _geometric(N, N // 2, 31)[0], nsv=4, kdim=12,
                        tolerance=1e-9, maxiter=40),
    "restart-c128": dict(A=lambda: _geometric(N, N // 2, 31, True)[0], nsv=4, kdim=12,
                         tolerance=1e-9, maxiter=40),
    "restart-check-every-4": dict(A=lambda: _geometric(N, N // 2, 32)[0], nsv=3, kdim=12,
                                  tolerance=1e-9, maxiter=40, check_every=4),
    # the plain versions of K1 (stencil) and K3 (Block-ELL matvec)
    "stencil-poisson-16": dict(op=_poisson_pallas, u0=(16, 16), nsv=2, kdim=24, tolerance=1e-6,
                               maxiter=40),
    "bell-convdiff-16": dict(op=_convdiff_bell, u0=(256,), nsv=3, kdim=30, tolerance=1e-8,
                             maxiter=40),
}


def _svds_inputs(c):
    """(JAX operator, dense matrix, u0, v template) of a case."""
    if "A" in c:
        A = c.pop("A")()
        m, n = A.shape
        cplx = np.iscomplexobj(A)
        return lk.DenseOperator(jnp.asarray(A)), A, _draw(m, 9, cplx), np.zeros(n, A.dtype)
    op = c.pop("op")()
    shape = c.pop("u0")
    dense = (lt.Poisson2D(16).dense().numpy() if isinstance(op, PallasPoisson2D)
             else lt.ConvectionDiffusion2D(16).dense().numpy())
    return op, dense, _draw(shape, 10), None


@pytest.mark.parametrize("case", list(SVDS_CASES))
def test_svds_matches_jax(case):
    c = dict(SVDS_CASES[case])
    op_j, A, u0, v_t = _svds_inputs(c)
    nsv = c.pop("nsv")
    opts = lk.SVDSOptions(maxiter=c.pop("maxiter", 20))
    vt_j = None if v_t is None else jnp.asarray(v_t)
    vt_t = None if v_t is None else torch.from_numpy(v_t)
    jtimer.reset_counters()
    lt.timer.reset_counters()
    Uj, Sj, Vj, rj, infoj, mj = lk.svds(op_j, nsv, u0=jnp.asarray(u0), v_template=vt_j,
                                        options=opts, **c)
    op_t = port_operator(op_j)
    Ut, St, Vt, rt, infot, mt = lt.svds(op_t, nsv, u0=torch.from_numpy(u0), v_template=vt_t,
                                        options=port_options(opts), **c)
    assert infot == infoj == nsv
    assert (mt.n_iter, mt.converged) == (mj.n_iter, mj.converged)
    assert St.dtype == rt.dtype == np.float64
    scale = float(np.max(Sj))
    assert np.abs(St - np.asarray(Sj)).max() <= SV_TOL * scale
    dense_sv = np.linalg.svd(A, compute_uv=False)[:nsv]
    assert np.abs(St - dense_sv).max() <= SV_TOL * scale
    assert np.all(np.abs(rt - np.asarray(rj)) <= SV_TOL * scale)
    assert mt.residuals.shape == np.asarray(mj.residuals).shape
    assert np.all(np.abs(mt.residuals - np.asarray(mj.residuals)) <= SV_TOL * scale)
    for Xt, Xj in ((Ut, Uj), (Vt, Vj)):
        Xt, Xj = Xt.numpy().reshape(nsv, -1), np.asarray(Xj).reshape(nsv, -1)
        assert np.allclose(np.abs(np.sum(Xj.conj() * Xt, axis=1)), 1.0, atol=1e-6)
    # the triplets: A v_i = s_i u_i
    Um, Vm = Ut.numpy().reshape(nsv, -1), Vt.numpy().reshape(nsv, -1)
    for i in range(nsv):
        assert np.linalg.norm(A @ Vm[i] - St[i] * Um[i]) <= 1e-6 * scale
    name, jname = type(op_t).__name__, type(op_j).__name__
    for kind in ("matvec", "rmatvec"):
        assert lt.timer.get_counter(f"{name}.{kind}") == \
            jtimer.get_counter(f"{jname}.{kind}") == mt.n_iter
    if case.startswith("restart"):
        assert mt.n_iter > c["kdim"]


def test_svds_zero_start_draws_from_the_generator():
    A, sv = _geometric(N, N // 2, 33)
    op = lt.DenseOperator(torch.from_numpy(A))
    u0 = torch.zeros(N, dtype=torch.float64)
    v_t = torch.zeros(N // 2, dtype=torch.float64)
    runs = [lt.svds(op, 2, u0=u0, v_template=v_t, kdim=20,
                    generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert runs[0][4] == 2 and np.array_equal(runs[0][1], runs[1][1])
    default = lt.svds(op, 2, u0=u0, v_template=v_t, kdim=20)
    assert default[4] == 2 and np.allclose(default[1], sv[:2], rtol=1e-8)


def test_svds_reads_the_host_once_per_step():
    """One read per Golub-Kahan step, plus the start-vector norm and the B
    of each check."""
    A, _ = _geometric(N, N // 2, 34)
    lt.timer.reset_counters()
    _, _, _, _, _, meta = lt.svds(lt.DenseOperator(torch.from_numpy(A)), 2,
                                  u0=torch.from_numpy(_draw(N, 11)),
                                  v_template=torch.zeros(N // 2, dtype=torch.float64), kdim=10,
                                  tolerance=1e-30, options=lt.SVDSOptions(maxiter=3))
    checks = len(meta.residuals) // 2
    assert lt.timer.get_counter("host_reads") == meta.n_iter + checks + 1


@pytest.mark.parametrize("kwargs,err", [
    (dict(options=lt.SVDSOptions(projected="device")), NotImplementedError),
    (dict(options=lt.SVDSOptions(projected="gpu")), ValueError),
], ids=["device", "unknown"])
def test_svds_refuses_what_is_not_ported(kwargs, err):
    op = lt.DenseOperator(torch.eye(8, dtype=torch.float64))
    with pytest.raises(err, match="M10|unknown"):
        lt.svds(op, 2, u0=torch.ones(8, dtype=torch.float64), **kwargs)


def test_svds_requires_u0_and_ports_options():
    with pytest.raises(ValueError, match="u0"):
        lt.svds(lt.DenseOperator(torch.eye(8, dtype=torch.float64)), 2)
    opts = lk.SVDSOptions(kdim=12, maxiter=3, projected="host", checkpoint_every=2,
                          checkpoint_path="svds.npz")
    assert port_options(opts) == lt.SVDSOptions(kdim=12, maxiter=3, projected="host",
                                                checkpoint_every=2, checkpoint_path="svds.npz")
