"""The port's Lanczos and ``eighs`` against the JAX package's, on the same
operators and start vectors.

The JAX ``eighs`` takes its host projected path on the CPU ("auto" is host
off a TPU), which is the path the port implements, so the two agree in
method: iteration counts, ``info`` and the convergence flag are equal, and
eigenvalues, Ritz residual histories and Ritz vectors agree within the
float64 ``rtol`` of ``constants.py`` (about 3.2e-8).  Ritz vectors are
compared up to sign (``|<v_jax, v_port>| = 1``).  Start vectors are seeded
numpy vectors handed to both packages: the port draws random numbers from a
``torch.Generator``, which does not give JAX's numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.krylov.lanczos import initialize_lanczos as j_init
from lightkrylov_tpu.krylov.lanczos import lanczos as j_lanczos
from lightkrylov_tpu.models import TridiagToeplitz as JToeplitz
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

RTOL = lk.constants.rtol(np.float64)


def _hermitian(n, seed, complex_=True):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    if complex_:
        B = B + 1j * rng.standard_normal((n, n))
    return (B + B.conj().T) / 2 + np.diag(np.linspace(0.0, 20.0, n))


def _x0(shape, seed, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.linalg.norm(got - ref) <= rtol * max(np.linalg.norm(ref), 1e-300)


# -- vectors.rand_like / rand_basis -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_rand_like_follows_the_generator(dtype):
    x = {"u": torch.zeros(300, 40, dtype=dtype), "v": [torch.zeros(7, dtype=dtype)]}
    a = lt.rand_like(torch.Generator().manual_seed(3), x)
    b = lt.rand_like(torch.Generator().manual_seed(3), x)
    assert a["u"].dtype == dtype and a["v"][0].shape == (7,)
    assert torch.equal(a["u"], b["u"]) and torch.equal(a["v"][0], b["v"][0])
    if dtype.is_complex:  # standard-normal real and imaginary parts, as in JAX
        assert abs(float(a["u"].real.std()) - 1) < 0.05
        assert abs(float(a["u"].imag.std()) - 1) < 0.05
    else:
        assert abs(float(a["u"].std()) - 1) < 0.05
    n = lt.rand_like(torch.Generator().manual_seed(4), x, ifnorm=True)
    assert abs(float(lt.norm(n)) - 1) < 1e-5


def test_rand_basis_columns_differ():
    X = lt.zeros_basis(torch.zeros(50, dtype=torch.float64), 4)
    B = lt.rand_basis(torch.Generator().manual_seed(0), X, ifnorm=True)
    assert B.shape == (4, 50)
    G = lt.gram(B).numpy()
    assert np.allclose(np.diag(G), 1.0)
    assert np.all(np.abs(G - np.diag(np.diag(G))) < 0.7)


# -- lanczos ------------------------------------------------------------------

def _lanczos_pair(op_j, x0, kdim, sweeps):
    """The (X, T, info) of both packages after the given (kstart, kend)
    sweeps from the same start vector."""
    Xj, Tj = j_init(jnp.asarray(x0), kdim)
    Xt, Tt = lt.initialize_lanczos(torch.from_numpy(x0), kdim)
    op_t = port_operator(op_j)
    for k0, k1 in sweeps:
        Xj, Tj, ij = j_lanczos(op_j, Xj, Tj, kstart=k0, kend=k1)
        Xt, Tt, it = lt.lanczos(op_t, Xt, Tt, kstart=k0, kend=k1)
        assert it.dtype == torch.int32 and int(it) == int(ij)
    return (Xj, Tj, ij), (Xt, Tt, it)


@pytest.mark.parametrize("case", ["toeplitz-f64", "dense-c128"])
@pytest.mark.parametrize("sweeps", [[(1, 12)], [(1, 5), (6, 12)]], ids=["one", "two"])
def test_lanczos_matches_jax(case, sweeps):
    if case == "toeplitz-f64":
        op_j, x0 = JToeplitz(60, 2.0, -1.0), _x0(60, 0)
    else:
        op_j = lk.DenseOperator(jnp.asarray(_hermitian(40, 1)), is_hermitian=True)
        x0 = _x0(40, 2, complex_=True)
    (Xj, Tj, ij), (Xt, Tt, it) = _lanczos_pair(op_j, x0, 12, sweeps)
    assert int(it) == 0
    assert Tt.dtype == lt.constants.as_torch_dtype(np.asarray(Tj).dtype)
    _close(Tt.numpy(), Tj)
    _close(Xt.numpy(), Xj)
    # the factorization A X_k = X_{k+1} T_k holds
    A = np.asarray(op_j.dense() if case == "toeplitz-f64" else op_j.data)
    X = Xt.numpy()
    assert np.linalg.norm(A @ X[:12].T - X.T @ Tt.numpy()) < 1e-10 * np.linalg.norm(A)


def test_lanczos_breakdown_on_an_invariant_subspace():
    """x0 in the span of three eigenvectors: breakdown at step 3, info = 3,
    in both packages; the later columns stay zero."""
    d = np.linspace(1.0, 30.0, 30)
    x0 = np.zeros(30)
    x0[[2, 11, 20]] = [1.0, -2.0, 0.5]
    op_j = lk.DenseOperator(jnp.asarray(np.diag(d)), is_hermitian=True)
    (Xj, Tj, ij), (Xt, Tt, it) = _lanczos_pair(op_j, x0, 8, [(1, 8)])
    assert int(ij) == int(it) == 3
    _close(Tt.numpy(), Tj)
    assert float(Tt[3, 2]) == 0.0 and not Xt[4:].any()


def test_lanczos_nan_is_fatal():
    op = lt.MatvecOperator(lambda x: x * float("nan"), is_hermitian=True)
    X, T = lt.initialize_lanczos(torch.ones(10, dtype=torch.float64), 5)
    _, _, info = lt.lanczos(op, X, T)
    assert int(info) == -1
    with pytest.raises(LightKrylovError, match="lanczos"):
        lt.eighs(op, 2, x0=torch.ones(10, dtype=torch.float64), kdim=5)


# -- eighs --------------------------------------------------------------------

def _poisson_bell(nx):
    dense = lt.Poisson2D(nx).dense().numpy()
    return JBellOperator(j_bell_from_scipy(sp.csr_matrix(dense), bm=8, bn=128,
                                           dtype=np.float64),
                         is_hermitian=True, interpret=True)


EIGHS_CASES = {
    # thick restarts (maxiter > 1): kdim 20 holds 4 pairs of a clustered top
    "toeplitz-restart": dict(op=lambda: JToeplitz(200, 2.0, -1.0), x0=(200,), nev=4,
                             kdim=20, tolerance=1e-10, maxiter=50),
    "dense-f64-check-every-1": dict(op=lambda: lk.DenseOperator(
        jnp.asarray(_hermitian(80, 5, complex_=False)), is_hermitian=True),
        x0=(80,), nev=3, kdim=24, check_every=1),
    "dense-c128": dict(op=lambda: lk.DenseOperator(jnp.asarray(_hermitian(80, 3)),
                                                   is_hermitian=True),
                       x0=(80,), complex_=True, nev=3, kdim=24, maxiter=20, check_every=6),
    "bell-poisson-12": dict(op=lambda: _poisson_bell(12), x0=(144,), nev=3, kdim=30,
                            maxiter=20),
    "stencil-poisson-24x16": dict(op=lambda: PallasPoisson2D(24, 16, dtype=jnp.float64,
                                                             tile=8, interpret=True),
                                  x0=(16, 24), nev=2, kdim=24, maxiter=30, tolerance=1e-6),
}


@pytest.mark.parametrize("case", list(EIGHS_CASES))
def test_eighs_matches_jax(case):
    c = dict(EIGHS_CASES[case])
    op_j = c.pop("op")()
    x0 = _x0(c.pop("x0"), 4, complex_=c.pop("complex_", False))
    opts = lk.EigsOptions(maxiter=c.pop("maxiter", 20))
    jtimer.reset_counters()
    lt.timer.reset_counters()
    wj, Vj, rj, infoj, metaj = lk.eighs(op_j, x0=jnp.asarray(x0), options=opts, **c)
    op_t = port_operator(op_j)
    wt, Vt, rt, infot, metat = lt.eighs(op_t, x0=torch.from_numpy(x0),
                                        options=port_options(opts), **c)
    assert infot == infoj and infot > 0
    assert (metat.n_iter, metat.n_inner, metat.converged) == \
        (metaj.n_iter, metaj.n_inner, metaj.converged)
    assert wt.dtype == np.float64 and rt.dtype == np.float64
    _close(wt, wj)
    scale = float(np.abs(wj).max())
    assert np.all(np.abs(rt - np.asarray(rj)) <= RTOL * scale)
    hj = np.asarray(metaj.residuals)
    assert metat.residuals.shape == hj.shape
    assert np.all(np.abs(metat.residuals - hj) <= RTOL * scale)
    Vj, Vt = np.asarray(Vj).reshape(len(wj), -1), Vt.numpy().reshape(len(wt), -1)
    overlap = np.abs(np.sum(Vj.conj() * Vt, axis=1))
    assert np.allclose(overlap, 1.0, atol=1e-6)
    name = type(op_t).__name__
    jname = type(op_j).__name__
    assert lt.timer.get_counter(f"{name}.matvec") == jtimer.get_counter(f"{jname}.matvec") \
        == metat.n_iter
    if "restart" in case:
        assert metat.n_iter > c["kdim"]


def test_eighs_finds_the_analytic_spectra():
    op = lt.TridiagToeplitz(300, 2.0, -1.0)
    w, V, r, info, meta = lt.eighs(op, 5, x0=torch.from_numpy(_x0(300, 5)), kdim=24,
                                   tolerance=1e-10, options=lt.EigsOptions(maxiter=80))
    assert info == 5 and meta.converged
    want = np.sort(lt.toeplitz_eigvals(300, 2.0, -1.0).real)[::-1][:5]
    assert np.allclose(w, want, rtol=0, atol=1e-9)
    Vm = V.numpy()
    resid = np.array([np.linalg.norm(op.matvec(V[i]).numpy() - w[i] * Vm[i]) for i in range(5)])
    assert np.all(resid < 1e-8)
    # kdim below the operator's dimension (100): see ROADMAP F7
    w2, _, _, info2, _ = lt.eighs(lt.Poisson2D(10), 3, x0=torch.from_numpy(_x0((10, 10), 6)),
                                  kdim=60)
    assert info2 > 0
    assert np.allclose(w2, lt.poisson2d_eigvals(10)[::-1][:3], rtol=1e-10)


def test_eighs_invariant_start_matches_jax():
    d = np.linspace(1.0, 30.0, 30)
    x0 = np.zeros(30)
    x0[[2, 11, 20, 29]] = [1.0, -2.0, 0.5, 1.0]
    op_j = lk.DenseOperator(jnp.asarray(np.diag(d)), is_hermitian=True)
    ref = lk.eighs(op_j, 2, x0=jnp.asarray(x0), kdim=10)
    got = lt.eighs(port_operator(op_j), 2, x0=torch.from_numpy(x0), kdim=10)
    assert got[3] == ref[3] and got[4].converged and got[4].n_iter == ref[4].n_iter == 4
    _close(got[0], ref[0])
    assert np.allclose(got[0], [30.0, d[20]])


def test_eighs_zero_start_draws_from_the_generator():
    op = lt.TridiagToeplitz(120, 2.0, -1.0)
    x0 = torch.zeros(120, dtype=torch.float64)
    runs = [lt.eighs(op, 2, x0=x0, kdim=60, generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert runs[0][3] == 2 and np.array_equal(runs[0][0], runs[1][0])
    default = lt.eighs(op, 2, x0=x0, kdim=60)
    assert default[3] == 2
    assert np.allclose(default[0], np.sort(lt.toeplitz_eigvals(120, 2.0, -1.0).real)[::-1][:2])


def test_eighs_reads_the_host_once_per_step():
    """One read per Lanczos step, plus the start-vector norm and the T of
    each check."""
    lt.timer.reset_counters()
    _, _, _, _, meta = lt.eighs(lt.TridiagToeplitz(100, 2.0, -1.0), 2,
                                x0=torch.from_numpy(_x0(100, 7)), kdim=20,
                                options=lt.EigsOptions(maxiter=3), tolerance=1e-30)
    checks = len(meta.residuals) // 2
    assert lt.timer.get_counter("host_reads") == meta.n_iter + checks + 1


@pytest.mark.parametrize("kwargs,err", [
    (lambda tmp: dict(options=lt.EigsOptions(projected="device")), NotImplementedError),
    # checkpoints are ported: what is refused is a path that cannot be
    # written, and a resume file that is not there
    (lambda tmp: dict(options=lt.EigsOptions(checkpoint_every=1, maxiter=2,
                                             checkpoint_path=str(tmp / "no-dir" / "x.npz")),
                      tolerance=1e-30), FileNotFoundError),
    (lambda tmp: dict(resume_from=str(tmp / "state.npz")), FileNotFoundError),
    (lambda tmp: dict(options=lt.EigsOptions(write_intermediate=True)), NotImplementedError),
    (lambda tmp: dict(options=lt.EigsOptions(projected="gpu")), ValueError),
], ids=["device", "checkpoint", "resume", "write-intermediate", "unknown"])
def test_eighs_refuses_what_is_not_ported(kwargs, err, tmp_path):
    op = lt.TridiagToeplitz(20, 2.0, -1.0)
    with pytest.raises(err, match="M10|M13|read by eigs|unknown|No such file"):
        lt.eighs(op, 2, x0=torch.ones(20, dtype=torch.float64), **kwargs(tmp_path))


def test_eighs_requires_x0_and_ports_options():
    with pytest.raises(ValueError, match="x0"):
        lt.eighs(lt.TridiagToeplitz(20, 2.0, -1.0), 2)
    opts = lk.EigsOptions(kdim=12, maxiter=3, projected="host")
    assert port_options(opts) == lt.EigsOptions(kdim=12, maxiter=3, projected="host")
