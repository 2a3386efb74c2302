"""The port's Ginzburg-Landau operators and propagator against the JAX
package's (reference: example/ginzburg_landau), on the same seeded numpy
states: the complex and the realified operator, their adjoints and dense
forms, the RK4 propagator, ``port_operator`` on each (the propagator with
its nested generator), and a small-``nx`` ``eigs`` of the propagator with
the same ``info`` and ``n_iter`` as JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import ginzburg_landau as jgl
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.models import ginzburg_landau as tgl

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

NX = 48


def _state(shape, seed, complex_):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape)
    return u + 1j * rng.standard_normal(shape) if complex_ else u


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref))


def _ops(kind, dtype):
    """The JAX operator of ``kind`` in ``dtype`` and its port."""
    j = (jgl.GinzburgLandau(NX, dtype=dtype) if kind == "complex"
         else jgl.GinzburgLandauReal(NX, dtype=dtype))
    return j, port_operator(j)


CASES = [("complex", np.complex128, 1e-13), ("complex", np.complex64, 1e-6),
         ("real", np.float64, 1e-13), ("real", np.float32, 1e-6)]


@pytest.mark.parametrize("kind,dtype,tol", CASES, ids=["c128", "c64", "f64", "f32"])
def test_gl_matches_jax(kind, dtype, tol):
    """matvec, rmatvec and dense against JAX; <A u, v> = <u, A^H v>."""
    op_j, op = _ops(kind, dtype)
    shape = (NX,) if kind == "complex" else (2, NX)
    u = _state(shape, 0, kind == "complex").astype(dtype)
    v = _state(shape, 1, kind == "complex").astype(dtype)
    assert type(op).__name__ == type(op_j).__name__ and op.mu.dtype == torch.from_numpy(u).dtype
    assert tuple(op.template().shape) == shape
    for mv in ("matvec", "rmatvec"):
        got = getattr(op, mv)(torch.from_numpy(u)).numpy()
        assert got.dtype == u.dtype
        assert _rel(got, getattr(op_j, mv)(jnp.asarray(u))) < tol
    assert _rel(op.dense(), op_j.dense()) < tol
    lhs = complex(lt.dot(op.matvec(torch.from_numpy(u)), torch.from_numpy(v)))
    rhs = complex(lt.dot(torch.from_numpy(u), op.rmatvec(torch.from_numpy(v))))
    assert abs(lhs - rhs) < 10 * tol * abs(lhs)
    dense = op.dense()
    assert _rel(op.matvec(torch.from_numpy(u)).numpy().ravel(), dense @ u.ravel()) < tol


def test_realified_equals_complex():
    """``GinzburgLandauReal`` is the realification of ``GinzburgLandau``:
    on ``[Re u; Im u]`` it gives ``[Re A u; Im A u]``, and likewise for
    the adjoints."""
    glc, glr = tgl.GinzburgLandau(NX), tgl.GinzburgLandauReal(NX, dtype=torch.float64)
    u = torch.from_numpy(_state(NX, 2, True))
    ur = torch.stack([u.real, u.imag])
    for mv in ("matvec", "rmatvec"):
        yc, yr = getattr(glc, mv)(u), getattr(glr, mv)(ur)
        assert _rel(yr.numpy(), np.stack([yc.real.numpy(), yc.imag.numpy()])) < 1e-14
    # the realified rmatvec is the transpose of the realified matvec
    R = glr.dense()
    assert _rel(glr.rmatvec(ur).numpy().ravel(), R.T @ ur.numpy().ravel()) < 1e-14


def test_gl_constants_and_analytic_spectrum():
    for name in ("NU", "GAMMA", "MU0", "C_MU", "MU2"):
        assert getattr(tgl, name) == getattr(jgl, name)
    assert np.array_equal(lt.gl_analytic_eigvals(5), jgl.gl_analytic_eigvals(5))
    dense_ev = np.linalg.eigvals(lt.GinzburgLandau(512).dense())
    dense_ev = dense_ev[np.argsort(-dense_ev.real)]
    assert np.all(np.abs(dense_ev[:3] - lt.gl_analytic_eigvals(3)) < 2e-2)


@pytest.mark.parametrize("kind,dtype,tol", CASES, ids=["c128", "c64", "f64", "f32"])
def test_propagator_matches_jax(kind, dtype, tol):
    """RK4 propagator exp(tau A) and its adjoint, ported with its nested
    generator."""
    gen_j, _ = _ops(kind, dtype)
    Pj = jgl.GLPropagator(gen_j, tau=0.05, n_steps=10)
    P = port_operator(Pj)
    assert isinstance(P, lt.GLPropagator) and type(P.A).__name__ == type(gen_j).__name__
    assert (P.tau, P.n_steps) == (0.05, 10)
    shape = (NX,) if kind == "complex" else (2, NX)
    u = _state(shape, 3, kind == "complex").astype(dtype)
    for mv in ("matvec", "rmatvec"):
        assert _rel(getattr(P, mv)(torch.from_numpy(u)).numpy(),
                    getattr(Pj, mv)(jnp.asarray(u))) < 10 * tol


def test_gl_eigs_matches_jax():
    """Leading eigenvalues through eigs on the propagator, realified f64 and
    complex c128 at small nx: the same info and n_iter as JAX, the same
    Ritz values, and log(mu)/tau on the dense spectrum
    (tests/test_ginzburg_landau.py:79-108)."""
    wc = np.linalg.eigvals(lt.GinzburgLandau(NX).dense())
    wc = wc[np.argsort(-wc.real)][:4]
    for kind, dtype, nev, kdim in (("real", np.float64, 8, 24), ("complex", np.complex128, 4, 16)):
        gen_j, _ = _ops(kind, dtype)
        Pj = jgl.GLPropagator(gen_j, tau=0.01, n_steps=10)
        x0 = _state((NX,) if kind == "complex" else (2, NX), 4, kind == "complex")
        wj, _, _, infoj, metaj = lk.eigs(Pj, nev, x0=jnp.asarray(x0), kdim=kdim, tolerance=1e-8,
                                         options=lk.EigsOptions(maxiter=100))
        w, V, r, info, meta = lt.eigs(port_operator(Pj), nev, x0=torch.from_numpy(x0), kdim=kdim,
                                      tolerance=1e-8, options=lt.EigsOptions(maxiter=100))
        assert info == infoj == nev and meta.n_iter == metaj.n_iter
        d = np.abs(w[:, None] - np.asarray(wj)[None, :])
        assert max(d.min(0).max(), d.min(1).max()) < 1e-10
        lam = np.log(w.astype(complex)) / 0.01
        for ev in wc:
            dev = np.abs(lam - ev).min()
            if kind == "real":
                dev = min(dev, np.abs(lam - np.conj(ev)).min())
            assert dev < 1e-6, f"eigenvalue {ev} missing from the {kind} Ritz set"
