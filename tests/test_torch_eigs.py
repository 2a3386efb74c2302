"""The port's ``eigs`` and the dense linear algebra of its projected
problems against the JAX package's, on the same operators and start
vectors.

The JAX ``eigs`` takes its host projected path on the CPU ("auto" is host
off a TPU), which is the path the port implements, so the two agree in
method: ``info``, ``n_iter`` and the convergence flag are equal, and the
Ritz values agree within the float64 ``rtol`` of ``constants.py``.  The
counterparts of ``tests/test_eigensolvers.py:23-127,183-193,214-233``
check the closed-form spectra as the JAX tests do.  On a non-normal
operator the two packages' restarts amplify rounding differences, so that
case is held to its true residual ``||A v - lambda v||`` instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import ConvectionDiffusion2D as JConvDiff
from lightkrylov_tpu.models import TridiagToeplitz as JToeplitz
from lightkrylov_tpu.models import toeplitz_eigvals
from lightkrylov_tpu.utils import linalg as jla
from lightkrylov_tpu_torch.convert import port_operator, port_options
from lightkrylov_tpu_torch.utils import linalg as tla
from lightkrylov_tpu_torch.utils.logger import LightKrylovError

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

N = 128
RTOL = lk.constants.rtol(np.float64)


def _x0(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _rotation_op(seed=0):
    """Real operator with conjugate pairs r_i e^{+-i theta_i}, moduli
    decaying geometrically (tests/test_eigensolvers.py:73-91)."""
    rng = np.random.default_rng(seed)
    r = 2.0 * 0.7 ** np.arange(N // 2)
    theta = rng.uniform(0.2, np.pi - 0.2, N // 2)
    A = np.zeros((N, N))
    for i, (ri, ti) in enumerate(zip(r, theta)):
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] = ri * np.array([[np.cos(ti), -np.sin(ti)],
                                                            [np.sin(ti), np.cos(ti)]])
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    exact = np.concatenate([r * np.exp(1j * theta), r * np.exp(-1j * theta)])
    return lk.DenseOperator(jnp.asarray(Q @ A @ Q.T)), exact


def _complex_normal_op():
    """Complex normal operator with a geometric spectrum
    (tests/test_eigensolvers.py:214-233)."""
    rng = np.random.default_rng(21)
    d = 2.0 * 0.7 ** np.arange(N) * np.exp(1j * rng.uniform(0, 2 * np.pi, N))
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    return lk.DenseOperator(jnp.asarray((Q * d) @ Q.conj().T)), d


def _both(op_j, nev, x0, maxiter=20, **kw):
    """The same eigs call in each package."""
    ref = lk.eigs(op_j, nev, x0=jnp.asarray(x0), options=lk.EigsOptions(maxiter=maxiter), **kw)
    got = lt.eigs(port_operator(op_j), nev, x0=torch.from_numpy(x0),
                  options=lt.EigsOptions(maxiter=maxiter), **kw)
    return ref, got


def _same_run(ref, got):
    wj, _, rj, infoj, metaj = ref
    wt, Vt, rt, infot, metat = got
    assert infot == infoj and (metat.n_iter, metat.converged) == (metaj.n_iter, metaj.converged)
    assert wt.dtype == np.asarray(wj).dtype and rt.dtype == np.asarray(rj).dtype
    # eigenvalues of equal modulus (conjugate pairs) are ordered by rounding,
    # so each is matched to the nearest of the other package's
    d = np.abs(wt[:, None] - np.asarray(wj)[None, :])
    assert max(d.min(0).max(), d.min(1).max()) <= RTOL * np.abs(wj).max()
    assert metat.residuals.shape == np.asarray(metaj.residuals).shape


EIGS_CASES = {
    # skew off-diagonals: a normal operator, eigenvalues a +- 2bi cos(k pi/(n+1))
    # (tests/test_eigensolvers.py:23-47)
    "toeplitz-rdp": dict(op=lambda: (JToeplitz(N, 2.0, -1.0, 1.0),
                                     toeplitz_eigvals(N, 2.0, -1.0, 1.0)),
                         nev=6, kdim=32, tolerance=1e-9, dtype=np.float64),
    "toeplitz-cdp": dict(op=lambda: (JToeplitz(N, 2.0, -1.0, 1.0, dtype=np.complex128),
                                     toeplitz_eigvals(N, 2.0, -1.0, 1.0)),
                         nev=6, kdim=32, tolerance=1e-9, dtype=np.complex128),
    # b c < 0: complex pairs of a real operator (:50-70)
    "complex-pairs": dict(op=lambda: (JToeplitz(N, 1.0, 1.0, -1.0),
                                      toeplitz_eigvals(N, 1.0, 1.0, -1.0)),
                          nev=4, kdim=32, tolerance=1e-9, dtype=np.float64),
    # small kdim forces Krylov-Schur restarts (:94-109)
    "restart-rotation": dict(op=_rotation_op, nev=4, kdim=12, tolerance=1e-9,
                             dtype=np.float64, maxiter=60),
    # per-step checks (:112-125)
    "check-every-1": dict(op=_rotation_op, nev=4, kdim=24, tolerance=1e-9,
                          dtype=np.float64, check_every=1),
    # the complex Schur path of the restart (:214-233)
    "restart-complex": dict(op=_complex_normal_op, nev=4, kdim=12, tolerance=1e-9,
                            dtype=np.complex128, maxiter=60),
    # a custom restart selector: keep the 7 Ritz values of largest modulus
    "custom-select": dict(op=_rotation_op, nev=4, kdim=12, tolerance=1e-9,
                          dtype=np.float64, maxiter=60,
                          select=lambda w: np.abs(w) >= np.sort(np.abs(w))[-7]),
}


@pytest.mark.parametrize("case", list(EIGS_CASES))
def test_eigs_matches_jax(case):
    c = dict(EIGS_CASES[case])
    op_j, exact = c.pop("op")()
    dtype = c.pop("dtype")
    ref, got = _both(op_j, x0=_x0(N, 3, dtype), **c)
    _same_run(ref, got)
    w, V, r, info, meta = got
    assert meta.converged and info == c["nev"]
    for lam in w:
        assert np.min(np.abs(exact - lam) / np.abs(lam)) < 1e-8
    if "complex-pairs" in case:  # eigenvalues of a real operator come in pairs
        assert all(np.min(np.abs(w - np.conj(lam))) < 1e-8 for lam in w)
    if "restart" in case or "select" in case:
        assert meta.n_iter > c["kdim"]
    A = np.asarray(op_j.dense() if hasattr(op_j, "dense") else op_j.data).astype(complex)
    Vm = V.numpy()
    assert V.dtype == torch.complex128 and Vm.shape == (c["nev"], N)
    for i in range(c["nev"]):
        assert np.linalg.norm(A @ Vm[i] - w[i] * Vm[i]) < 1e-6


def test_eigs_check_every_saves_matvecs():
    """Per-step checks stop at the first converged step: no more matvecs
    than one check per sweep, and the same eigenvalues."""
    op = port_operator(_rotation_op()[0])
    x0 = torch.from_numpy(_x0(N, 4))
    w1, _, _, _, m1 = lt.eigs(op, 4, x0=x0, kdim=24, tolerance=1e-9)
    w2, _, _, _, m2 = lt.eigs(op, 4, x0=x0, kdim=24, tolerance=1e-9, check_every=1)
    assert m1.converged and m2.converged and m2.n_iter <= m1.n_iter
    assert np.allclose(w1, w2, atol=1e-8)


def test_eigs_nonnormal_by_true_residual():
    """The convection-diffusion operator is strongly non-normal: both
    packages converge, each pair has a true residual at rounding level, and
    the first sweep agrees before restarts amplify rounding."""
    op_j = JConvDiff(16)
    x0 = _x0((16, 16), 5)
    (wj, _, _, infoj, _), (w, V, r, info, meta) = _both(op_j, 4, x0, kdim=20,
                                                        tolerance=1e-10, maxiter=100)
    assert info == infoj == 4
    A = port_operator(op_j).dense().numpy()
    Vm = V.numpy().reshape(4, -1)
    for i in range(4):
        assert np.linalg.norm(A @ Vm[i] - w[i] * Vm[i]) / np.linalg.norm(Vm[i]) < 1e-8 * abs(w[0])
    ref1, got1 = _both(op_j, 4, x0, kdim=20, tolerance=1e-10, maxiter=1)
    _same_run(ref1, got1)


def test_eigs_invariant_start_matches_jax():
    """x0 in a 4-dimensional invariant subspace: exact after 4 steps."""
    d = np.linspace(1.0, 30.0, 30)
    x0 = np.zeros(30)
    x0[[2, 11, 20, 29]] = [1.0, -2.0, 0.5, 1.0]
    ref, got = _both(lk.DenseOperator(jnp.asarray(np.diag(d))), 2, x0, kdim=10)
    _same_run(ref, got)
    assert got[3] == 2 and got[4].n_iter == 4
    assert np.allclose(got[0], [30.0, d[20]])


def test_eigs_transpose_matches_jax():
    op_j, _ = _rotation_op(1)
    ref, got = _both(op_j, 4, _x0(N, 6), kdim=24, tolerance=1e-9, transpose=True)
    _same_run(ref, got)
    _, exact = _rotation_op(1)
    assert all(np.min(np.abs(exact - lam)) < 1e-8 for lam in got[0])


def test_eigs_writes_intermediate_and_spectrum(tmp_path):
    """``write_intermediate`` writes the last check's Ritz values as the JAX
    package does; ``save_eigenspectrum`` saves (re, im, residual) rows
    (reference: IterativeSolvers.fypp:882-925,944-963)."""
    op_j = JToeplitz(N, 1.0, 1.0, -1.0)
    x0 = _x0(N, 7)
    paths = [tmp_path / "jax.txt", tmp_path / "port.txt"]
    lk.eigs(op_j, 4, x0=jnp.asarray(x0), kdim=32, tolerance=1e-9,
            options=lk.EigsOptions(write_intermediate=True, outpost=str(paths[0])))
    w, _, r, _, _ = lt.eigs(port_operator(op_j), 4, x0=torch.from_numpy(x0), kdim=32,
                            tolerance=1e-9,
                            options=lt.EigsOptions(write_intermediate=True, outpost=str(paths[1])))
    rows = [np.loadtxt(p) for p in paths]
    assert rows[0].shape == rows[1].shape == (32, 3)
    assert np.abs(rows[0][:, :2] - rows[1][:, :2]).max() < RTOL * np.abs(w).max()
    for dt in (np.complex64, np.complex128):
        out = tmp_path / f"spec_{np.dtype(dt).name}.npy"
        lt.save_eigenspectrum(torch.tensor([1 + 2j, 3 - 4j], dtype=lt.constants.as_torch_dtype(dt)),
                              np.array([1e-12, 1e-11]), str(out))
        ref = tmp_path / f"ref_{np.dtype(dt).name}.npy"
        lk.save_eigenspectrum(jnp.asarray(np.array([1 + 2j, 3 - 4j], dt)),
                              jnp.asarray(np.array([1e-12, 1e-11])), str(ref))
        assert np.array_equal(np.load(out), np.load(ref))
        assert np.allclose(np.load(out), [[1, 2, 1e-12], [3, -4, 1e-11]])


def test_eigs_zero_start_draws_from_the_generator():
    op = port_operator(JToeplitz(N, 1.0, 1.0, -1.0))
    x0 = torch.zeros(N, dtype=torch.float64)
    runs = [lt.eigs(op, 2, x0=x0, kdim=32, tolerance=1e-9,
                    generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    assert runs[0][3] == 2 and np.array_equal(runs[0][0], runs[1][0])
    assert lt.eigs(op, 2, x0=x0, kdim=32, tolerance=1e-9)[3] == 2


def test_eigs_reads_the_host_once_per_step():
    """One read per Arnoldi step, plus the start-vector norm, ``H`` at each
    check and again at each restart."""
    lt.timer.reset_counters()
    _, _, _, _, meta = lt.eigs(port_operator(_rotation_op()[0]), 4,
                               x0=torch.from_numpy(_x0(N, 8)), kdim=12, tolerance=1e-30,
                               options=lt.EigsOptions(maxiter=3))
    checks = len(meta.residuals) // 4
    assert lt.timer.get_counter("host_reads") == meta.n_iter + checks + 1 + (checks - 1)


def test_eigs_times_its_host_solves():
    """With timing on, the host projected solves are timed spans."""
    lt.set_timing(True)
    try:
        before = {n: lt.timer.global_watch.timer(n).count
                  for n in ("eigs.projected_eig", "krylov_schur.schur_select")}
        _, _, _, _, meta = lt.eigs(port_operator(_rotation_op()[0]), 4,
                                   x0=torch.from_numpy(_x0(N, 8)), kdim=12, tolerance=1e-30,
                                   options=lt.EigsOptions(maxiter=3))
        after = {n: lt.timer.global_watch.timer(n).count for n in before}
    finally:
        lt.set_timing(False)
    assert after["eigs.projected_eig"] - before["eigs.projected_eig"] == 3
    assert after["krylov_schur.schur_select"] - before["krylov_schur.schur_select"] == 2


@pytest.mark.parametrize("kwargs,err", [
    # block mode is ported; it refuses what the JAX block driver refuses
    (lambda tmp: dict(blksize=2, resume_from=str(tmp / "state.npz")), NotImplementedError),
    # checkpoints are ported: what is refused is a path that cannot be
    # written, and a resume file that is not there
    (lambda tmp: dict(options=lt.EigsOptions(checkpoint_every=1, maxiter=2,
                                             checkpoint_path=str(tmp / "no-dir" / "x.npz")),
                      tolerance=1e-30), FileNotFoundError),
    (lambda tmp: dict(resume_from=str(tmp / "state.npz")), FileNotFoundError),
    (lambda tmp: dict(options=lt.EigsOptions(projected="gpu")), ValueError),
], ids=["block", "checkpoint", "resume", "unknown"])
def test_eigs_refuses_what_is_not_ported(kwargs, err, tmp_path):
    op = lt.TridiagToeplitz(20, 2.0, -1.0, 1.0)
    with pytest.raises(err, match="block mode|unknown|No such file"):
        lt.eigs(op, 2, x0=torch.ones(20, dtype=torch.float64), **kwargs(tmp_path))


def test_eigs_device_path_runs_and_matches_jax():
    """``projected="device"`` is ported: the port's device path (the
    Francis-QR kernel's plain version on the CPU, IRAM restarts) and the
    JAX package's converge on the same operator and start vector to the
    same Ritz values (100 tol) with the same converged count."""
    jop = JToeplitz(64, 2.0, -1.0, 1.0, dtype=jnp.float64)
    x0 = _x0(64, 21)
    opts = dict(projected="device", maxiter=60)
    w, _, r, info, meta = lt.eigs(port_operator(jop), 4, x0=torch.from_numpy(x0), kdim=16,
                                  tolerance=1e-9, check_every=4, options=lt.EigsOptions(**opts))
    jw, _, _, jinfo, _ = lk.eigs(jop, 4, x0=jnp.asarray(x0), kdim=16, tolerance=1e-9,
                                 check_every=4, options=lk.EigsOptions(**opts))
    assert meta.converged and info == jinfo == 4 and np.all(r < 1e-9)
    d = np.abs(w[:, None] - np.asarray(jw)[None, :])
    assert max(d.min(axis=0).max(), d.min(axis=1).max()) < 100 * 1e-9


def test_eigs_requires_x0():
    with pytest.raises(ValueError, match="x0"):
        lt.eigs(lt.TridiagToeplitz(20, 2.0, -1.0, 1.0), 2)
    with pytest.raises(LightKrylovError, match="arnoldi"):
        lt.eigs(lt.MatvecOperator(lambda x: x * float("nan")), 2, x0=torch.ones(8), kdim=4)


# -- utils/linalg ------------------------------------------------------------

def test_eig_and_schur_match_jax(dtype):
    rng = np.random.default_rng(10)
    A = rng.standard_normal((9, 9)).astype(dtype)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = (A + 1j * rng.standard_normal((9, 9))).astype(dtype)
    w, V = tla.eig(torch.from_numpy(A))
    wj, Vj = jla.eig(jnp.asarray(A))
    assert w.dtype == np.asarray(wj).dtype and np.array_equal(w, np.asarray(wj))
    T, Z = tla.schur(torch.from_numpy(A))
    Tj, Zj = jla.schur(jnp.asarray(A))
    assert T.dtype == A.dtype and np.array_equal(T, np.asarray(Tj))
    tol = lk.rtol(dtype)
    assert np.linalg.norm(Z @ T @ Z.conj().T - A) < tol * np.linalg.norm(A)


def test_schur_select_moves_pairs_whole(dtype_dp):
    """A selector that picks one eigenvalue of a conjugate pair moves the
    whole 2x2 block in a real Schur form; the result equals JAX's
    (reference: TRSEN, Utils.fypp:128-268)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((10, 10)).astype(dtype_dp)
    if np.issubdtype(np.dtype(dtype_dp), np.complexfloating):
        A = (A + 1j * rng.standard_normal((10, 10))).astype(dtype_dp)

    def top_imag(w):
        return np.arange(len(w)) == np.argmax(np.imag(w))

    T, Z, n = tla.schur_select(torch.from_numpy(A), top_imag)
    Tj, Zj, nj = jla.schur_select(jnp.asarray(A), top_imag)
    assert n == nj and np.array_equal(T, np.asarray(Tj)) and np.array_equal(Z, np.asarray(Zj))
    lead = np.linalg.eigvals(T[:n, :n])
    top = np.linalg.eigvals(A)[np.argmax(np.imag(np.linalg.eigvals(A)))]
    assert np.min(np.abs(lead - top)) < 1e-10
    assert n == (1 if np.iscomplexobj(A) else 2)
    T2, Z2 = tla.ordschur(*tla.schur(A), np.eye(10, dtype=bool)[3])
    assert np.linalg.norm(Z2 @ T2 @ Z2.conj().T - A) < 1e-12 * np.linalg.norm(A)


def test_sqrtm_expm_and_helpers_match_jax():
    rng = np.random.default_rng(12)
    M = rng.standard_normal((8, 8))
    S = M @ M.T + np.eye(8)
    root, info = tla.sqrtm(torch.from_numpy(S))
    rootj, infoj = jla.sqrtm(jnp.asarray(S))
    assert info == infoj == 0 and np.allclose(root.numpy(), np.asarray(rootj), atol=1e-12)
    assert np.allclose(root.numpy() @ root.numpy(), S, atol=1e-10)
    P = M[:, :3] @ M[:, :3].T  # rank 3: clipped eigenvalues
    assert tla.sqrtm(torch.from_numpy(P))[1] == jla.sqrtm(jnp.asarray(P))[1] == 1
    with pytest.raises(LightKrylovError, match="Hermitian"):
        tla.sqrtm(torch.from_numpy(M))
    E = tla.expm(torch.from_numpy(0.3 * M))
    assert np.allclose(E.numpy(), sla.expm(0.3 * M), rtol=1e-12, atol=1e-12)
    w, V = tla.eigh(torch.from_numpy(S))
    assert np.allclose(w.numpy(), np.linalg.eigvalsh(S))
    U, s, Vh = tla.svd(torch.from_numpy(M))
    assert np.allclose(s.numpy(), np.linalg.svd(M, compute_uv=False))
    assert float(tla.log2(8.0)) == float(jla.log2(8.0)) == 3.0
    tla.assert_shape(torch.zeros(3, 4), (3, 4))
    with pytest.raises(LightKrylovError, match="shape"):
        tla.assert_shape(torch.zeros(3, 4), (4, 3))


def test_eigs_options_port():
    opts = lk.EigsOptions(kdim=12, maxiter=3, write_intermediate=True, outpost="o.txt")
    assert port_options(opts) == lt.EigsOptions(kdim=12, maxiter=3, write_intermediate=True,
                                                outpost="o.txt")
