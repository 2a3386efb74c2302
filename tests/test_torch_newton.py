"""The port's nonlinear systems, Newton-Krylov, Roessler and OTD models
against the JAX package's, on the same inputs.

Everything runs in float64 (complex128 for the complex Jacobians) on the
CPU.  Jacobian actions, flows and OTD states agree within 1e-12 of their
scale: both packages evaluate the same RK4 arithmetic and differ only in
the order of a few roundings.  The Newton iterates and the per-evaluation
``(residual, tolerance)`` records agree within 1e-10 of the first residual:
near convergence the residuals are rounding noise of order 1e-15, so they
are compared absolutely.  The full anchors (UPO period to 1e-5 at 3000 RK4
steps, OTD at 20000 steps to 1e-7) take minutes of eager torch and are
marked ``slow``, as the JAX UPO test is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu import models as jm
from lightkrylov_tpu.systems import JacobianOperator as JJacobian
from lightkrylov_tpu.systems import System as JSystem
from lightkrylov_tpu.utils import timer as jtimer
from lightkrylov_tpu_torch.convert import port_options

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


TOL = 1e-12        # relative, Jacobian actions, flows, OTD states
REC_TOL = 1e-10    # relative to the first residual, Newton records and iterates
X0_FP = np.array([0.0, -1.0, 0.1])


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


# -- systems.JacobianOperator -------------------------------------------------

def _response(kind, xp):
    """The same map in numpy-like ``xp`` (jnp or torch): real, holomorphic
    complex, or complex with a conjugate (not holomorphic)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    if kind != "real":
        A = A + 1j * rng.standard_normal((6, 6))
    A = jnp.asarray(A) if xp is jnp else torch.from_numpy(A)
    conj = (lambda z: jnp.conj(z)) if xp is jnp else (lambda z: z.conj())
    if kind == "complex-conj":
        return lambda x: A @ (x * conj(x)) + 2.0 * x
    return lambda x: A @ (x * x) + xp.sin(x)


@pytest.mark.parametrize("kind", ["real", "complex", "complex-conj"])
def test_jacobian_operator_matches_jax(kind):
    rng = np.random.default_rng(4)
    shape = (6,)
    draw = (lambda: rng.standard_normal(shape)) if kind == "real" else \
        (lambda: rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    x, dx, dy = draw(), draw(), draw()
    Jj = JJacobian(_response(kind, jnp), jnp.asarray(x))
    Jt = lt.JacobianOperator(_response(kind, torch), torch.from_numpy(x))
    _close(Jt.matvec(torch.from_numpy(dx)).numpy(), Jj.matvec(jnp.asarray(dx)))
    _close(Jt.rmatvec(torch.from_numpy(dy)).numpy(), Jj.rmatvec(jnp.asarray(dy)))
    # the adjoint identity Re<dy, J dx> = Re<J^H dy, dx>
    a = np.vdot(dy, Jt.matvec(torch.from_numpy(dx)).numpy()).real
    b = np.vdot(Jt.rmatvec(torch.from_numpy(dy)).numpy(), dx).real
    assert abs(a - b) <= TOL * max(abs(a), 1.0)
    # with_state linearises about another state
    x2 = draw()
    _close(Jt.with_state(torch.from_numpy(x2)).matvec(torch.from_numpy(dx)).numpy(),
           Jj.with_state(jnp.asarray(x2)).matvec(jnp.asarray(dx)))


def test_system_takes_atol_and_a_user_jacobian():
    seen = []

    def response(x, atol):
        seen.append(atol)
        return x * x - 2.0

    s = lt.System(response, takes_atol=True)
    x = torch.tensor([1.0, 3.0], dtype=torch.float64)
    assert torch.equal(s.eval(x, 0.5), x * x - 2.0) and seen == [0.5]
    J = s.jacobian(x, 0.25)
    assert torch.allclose(J.matvec(torch.ones(2, dtype=torch.float64)), 2 * x)
    assert seen[-1] == 0.25
    user = lt.System(lambda x: x * x, jacobian=lambda x: torch.diag(3 * x))
    assert isinstance(user.jacobian(x), lt.DenseOperator)
    assert torch.allclose(user.jacobian(x).matvec(torch.ones(2, dtype=torch.float64)), 3 * x)


# -- Newton on the Roessler fixed point ----------------------------------------

def _recording(gmres):
    """A linear solver that records the iterate its Jacobian is taken at."""
    iterates = []

    def solver(J, b, **kw):
        iterates.append(_np(J.X))
        return gmres(J, b, **kw)

    solver.__name__ = "gmres"
    return solver, iterates


def _newton_pair(opts, sys_j=None, sys_t=None, X0=X0_FP, **kw):
    """Newton in both packages from ``X0``; returns both results and the
    recorded iterates."""
    sj, itj = _recording(lk.gmres)
    st, itt = _recording(lt.gmres)
    rj = lk.newton(sys_j or jm.fixed_point_system(), jnp.asarray(X0), solver=sj,
                   options=opts, **kw)
    rt = lt.newton(sys_t or lt.fixed_point_system(), torch.from_numpy(X0), solver=st,
                   options=port_options(opts), **kw)
    return rj, rt, itj, itt


def _same_run(rj, rt, itj, itt):
    (Xj, infoj, mj), (Xt, infot, mt) = rj, rt
    assert (infot, mt.converged, mt.n_iter, mt.n_evals) == \
        (infoj, mj.converged, mj.n_iter, mj.n_evals)
    scale = mj.residuals[0]
    assert np.abs(mt.residuals - mj.residuals).max() <= REC_TOL * scale
    assert np.abs(mt.tolerances - mj.tolerances).max() <= REC_TOL * scale
    assert len(itt) == len(itj)
    for a, b in zip(itt, itj):
        assert np.abs(a - b).max() <= REC_TOL * np.abs(b).max()
    _close(Xt.numpy(), Xj, REC_TOL)


@pytest.mark.parametrize("opts", [lk.NewtonOptions(),
                                  lk.NewtonOptions(ifbisect=True, maxstep_bisection=5)],
                         ids=["plain", "bisection"])
def test_newton_fixed_point_matches_jax(opts):
    """(tests/test_expm_newton.py:83-103)."""
    rj, rt, itj, itt = _newton_pair(opts, rtol=0.0, atol=1e-12)
    _same_run(rj, rt, itj, itt)
    X, info, meta = rt
    assert meta.converged and info > 0
    assert np.allclose(X.numpy(), jm.roessler_fixed_points()[0], atol=1e-9)


def test_newton_eval_accounting():
    """Every system.eval, bisection probes included, is counted and recorded
    (tests/test_expm_newton.py:106-134)."""
    for kw in (dict(), dict(ifbisect=True, maxstep_bisection=5)):
        lt.timer.reset_counters()
        jtimer.reset_counters()
        sys_t, sys_j = lt.fixed_point_system(), jm.fixed_point_system()
        _, _, meta = lt.newton(sys_t, torch.from_numpy(X0_FP), rtol=0.0, atol=1e-12,
                               options=lt.NewtonOptions(**kw))
        _, _, mj = lk.newton(sys_j, jnp.asarray(X0_FP), rtol=0.0, atol=1e-12,
                             options=lk.NewtonOptions(**kw))
        n = lt.timer.get_counter(f"{lt.timer.operator_label(sys_t)}.eval")
        assert n == meta.n_evals == len(meta.residuals) == len(meta.tolerances) == mj.n_evals
        assert jtimer.get_counter(f"{jtimer.operator_label(sys_j)}.eval") == n
        assert np.all(meta.tolerances > 0)
        if kw:
            assert n >= meta.n_iter * 5


@pytest.mark.parametrize("name", ["constant_tol", "dynamic_tol"])
def test_newton_schedulers_match_jax(name):
    """(tests/test_expm_newton.py:137-146)."""
    assert getattr(lt, name)(1e-9, 0.5, 3) == getattr(lk, name)(1e-9, 0.5, 3)
    assert lt.dynamic_tol(1e-9, 1e-12, 3) == 1e-9
    Xj, infoj, mj = lk.newton(jm.fixed_point_system(), jnp.asarray(X0_FP), rtol=0.0,
                              atol=1e-12, scheduler=getattr(lk, name))
    Xt, infot, mt = lt.newton(lt.fixed_point_system(), torch.from_numpy(X0_FP), rtol=0.0,
                              atol=1e-12, scheduler=getattr(lt, name))
    assert mt.converged and (infot, mt.n_evals) == (infoj, mj.n_evals)
    assert np.abs(mt.residuals - mj.residuals).max() <= REC_TOL * mj.residuals[0]
    assert np.abs(mt.tolerances - mj.tolerances).max() <= REC_TOL * mj.residuals[0]
    _close(Xt.numpy(), Xj, REC_TOL)
    assert np.allclose(Xt.numpy(), jm.roessler_fixed_points()[0], atol=1e-8)


def test_newton_target_tol_recheck_matches_jax():
    """A step that converges at a relaxed tolerance is evaluated again at
    the target (tests/test_expm_newton.py:207-231)."""

    def make(pkg, System):
        base = pkg.fixed_point_system()
        return System(lambda x, atol: base.eval(x, atol) + 0.3 * atol,
                      jacobian=lambda x: base.jacobian(x), takes_atol=True)

    X0 = np.zeros(3)
    rj, rt, itj, itt = _newton_pair(lk.NewtonOptions(), sys_j=make(jm, JSystem),
                                    sys_t=make(lt, lt.System), X0=X0, rtol=0.0, atol=1e-10,
                                    scheduler=lk.dynamic_tol)
    _same_run(rj, rt, itj, itt)
    X, info, meta = rt
    assert info > 0
    assert meta.residuals[-1] < 1e-10 + 0.31e-10
    assert np.sum(meta.tolerances == 1e-10) >= 2  # the recheck's record is there
    assert np.allclose(X.numpy(), jm.roessler_fixed_points()[0], atol=1e-8)


def test_newton_lucky_start_and_no_convergence():
    fp = jm.roessler_fixed_points()[0]
    X, info, meta = lt.newton(lt.fixed_point_system(), torch.from_numpy(fp), rtol=0.0,
                              atol=1e-8)
    assert meta.converged and info == 0 and meta.n_evals == 1
    _, info, meta = lt.newton(lt.fixed_point_system(), torch.from_numpy(X0_FP), rtol=0.0,
                              atol=1e-30, options=lt.NewtonOptions(maxiter=2))
    assert not meta.converged and info == -2 and meta.n_iter == 2


# -- the Roessler models --------------------------------------------------------

UPO_X0 = {"pos": np.array([0.0, 6.1, 1.3]), "T": np.array(6.0)}


def test_rhs_and_flow_match_jax():
    p = np.array([0.3, -1.2, 0.7])
    _close(lt.roessler_rhs(torch.from_numpy(p)).numpy(), jm.roessler_rhs(jnp.asarray(p)))
    got = lt.flow(torch.from_numpy(UPO_X0["pos"]), torch.tensor(6.0, dtype=torch.float64), 300)
    _close(got.numpy(), jm.flow(jnp.asarray(UPO_X0["pos"]), jnp.asarray(6.0), 300))
    for a, b in zip(lt.roessler_fixed_points(), jm.roessler_fixed_points()):
        assert np.array_equal(a, b)
        assert np.abs(lt.roessler_rhs(torch.from_numpy(a)).numpy()).max() < 1e-13


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rhs_and_flow_keep_float32(dtype):
    """A float32 state keeps float32 tangents through jvp (see roessler_rhs)."""
    pos = torch.tensor([0.0, 6.1, 1.3], dtype=dtype)
    J = lt.UPOJacobian({"pos": pos, "T": torch.tensor(6.0, dtype=dtype)}, 20)
    out = J.matvec({"pos": torch.ones(3, dtype=dtype), "T": torch.tensor(0.5, dtype=dtype)})
    assert out["pos"].dtype == out["T"].dtype == dtype


def test_upo_jacobian_matches_jax():
    """Exact jvp and vjp through 300 RK4 steps, against the JAX package's,
    and the phase-condition row."""
    rng = np.random.default_rng(5)
    state_j = {k: jnp.asarray(v) for k, v in UPO_X0.items()}
    state_t = {k: torch.from_numpy(v) for k, v in UPO_X0.items()}
    Jj, Jt = jm.UPOJacobian(state_j, 300), lt.UPOJacobian(state_t, 300)
    v = {"pos": rng.standard_normal(3), "T": np.array(rng.standard_normal())}
    w = {"pos": rng.standard_normal(3), "T": np.array(rng.standard_normal())}
    for op in ("matvec", "rmatvec"):
        for arg in (v, w):
            got = getattr(Jt, op)({k: torch.from_numpy(a) for k, a in arg.items()})
            ref = getattr(Jj, op)({k: jnp.asarray(a) for k, a in arg.items()})
            assert set(got) == {"pos", "T"}
            for k in ("pos", "T"):
                _close(got[k].numpy(), ref[k])
    # <w, J v> = <J^T w, v>
    Jv = Jt.matvec({k: torch.from_numpy(a) for k, a in v.items()})
    JTw = Jt.rmatvec({k: torch.from_numpy(a) for k, a in w.items()})
    lhs = float(lt.dot({k: torch.from_numpy(a) for k, a in w.items()}, Jv))
    rhs = float(lt.dot(JTw, {k: torch.from_numpy(a) for k, a in v.items()}))
    assert abs(lhs - rhs) <= TOL * abs(lhs)


def test_upo_system_and_monodromy_match_jax():
    sys_j, sys_t = jm.upo_system(200), lt.upo_system(200)
    Rj = sys_j.eval({k: jnp.asarray(v) for k, v in UPO_X0.items()})
    Rt = sys_t.eval({k: torch.from_numpy(v) for k, v in UPO_X0.items()})
    _close(Rt["pos"].numpy(), Rj["pos"])
    assert float(Rt["T"]) == 0.0
    assert isinstance(sys_t.jacobian({k: torch.from_numpy(v) for k, v in UPO_X0.items()}),
                      lt.UPOJacobian)
    Mt = lt.monodromy(torch.from_numpy(UPO_X0["pos"]), torch.tensor(6.0, dtype=torch.float64),
                      200)
    Mj = jm.monodromy(jnp.asarray(UPO_X0["pos"]), jnp.asarray(6.0), 200)
    _close(Mt.numpy(), Mj)
    mu_t, le_t = lt.floquet_exponents(torch.from_numpy(UPO_X0["pos"]),
                                      torch.tensor(6.0, dtype=torch.float64), 200)
    mu_j, le_j = jm.floquet_exponents(jnp.asarray(UPO_X0["pos"]), jnp.asarray(6.0), 200)
    # the third multiplier, about exp(-5.5 T), is rounding noise in both
    _close(np.abs(mu_t[:2]), np.abs(mu_j[:2]), 1e-10)
    _close(le_t[:2], le_j[:2], 1e-10)


def test_newton_upo_short_matches_jax():
    """Newton-Krylov shooting for the UPO at 100 RK4 steps: the same
    iterates, records and period as the JAX package."""
    n = 100
    X0j = {k: jnp.asarray(v) for k, v in UPO_X0.items()}
    X0t = {k: torch.from_numpy(v) for k, v in UPO_X0.items()}
    kw = dict(rtol=0.0, atol=1e-9)
    gopts = lk.GMRESOptions(kdim=4, maxiter=10)
    Xj, infoj, mj = lk.newton(jm.upo_system(n), X0j, options=lk.NewtonOptions(maxiter=20),
                              linear_solver_options=gopts, **kw)
    Xt, infot, mt = lt.newton(lt.upo_system(n), X0t, options=lt.NewtonOptions(maxiter=20),
                              linear_solver_options=port_options(gopts), **kw)
    assert (infot, mt.n_iter, mt.n_evals) == (infoj, mj.n_iter, mj.n_evals) and infot > 0
    assert np.abs(mt.residuals - mj.residuals).max() <= REC_TOL * mj.residuals[0]
    _close(Xt["pos"].numpy(), Xj["pos"], REC_TOL)
    assert abs(float(Xt["T"]) - float(Xj["T"])) <= REC_TOL * 6.0
    assert abs(float(Xt["T"]) - 5.88108845) < 1e-3  # RK4 at dt = T/100


@pytest.mark.slow
def test_newton_roessler_upo_anchor():
    """The UPO at the reference's resolution: T within 1e-5 of 5.88108845
    and the Floquet/Lyapunov anchors (tests/test_expm_newton.py:149-173)."""
    X0 = {k: torch.from_numpy(v) for k, v in UPO_X0.items()}
    X, info, meta = lt.newton(lt.upo_system(3000), X0, rtol=0.0, atol=1e-11,
                              options=lt.NewtonOptions(maxiter=60),
                              linear_solver_options=lt.GMRESOptions(kdim=4, maxiter=10))
    assert meta.converged, f"residuals: {meta.residuals}"
    assert abs(float(X["T"]) - 5.88108845) < 1e-5
    assert float(torch.linalg.norm(lt.flow(X["pos"], X["T"], 3000) - X["pos"])) < 1e-8
    _, LE = lt.floquet_exponents(X["pos"], X["T"], 4000)
    assert abs(LE[0] - 0.149141556) < 1e-6 and abs(LE[1]) < 1e-8


# -- OTD -------------------------------------------------------------------------

def _otd_start():
    fp = jm.roessler_fixed_points()[0]
    U0 = np.linalg.qr(np.random.default_rng(0).standard_normal((3, 2)))[0]
    return fp, U0


def test_otd_rhs_and_reorthonormalize_match_jax():
    from lightkrylov_tpu.models.otd import _reorthonormalize as j_reorth
    from lightkrylov_tpu_torch.models.otd import _reorthonormalize as t_reorth

    rng = np.random.default_rng(6)
    x, U = rng.standard_normal(3), rng.standard_normal((3, 2))
    for a, b in zip(lt.otd_rhs(lt.roessler_rhs, torch.from_numpy(x), torch.from_numpy(U)),
                    jm.otd_rhs(jm.roessler_rhs, jnp.asarray(x), jnp.asarray(U))):
        _close(a.numpy(), b)
    Q = t_reorth(torch.from_numpy(U)).numpy()
    _close(Q, j_reorth(jnp.asarray(U)))
    assert np.allclose(Q.T @ Q, np.eye(2), atol=1e-14)


def test_otd_evolve_matches_jax():
    """2000 RK4 steps over T = 5 from the fixed point."""
    fp, U0 = _otd_start()
    got = lt.otd_evolve(lt.roessler_rhs, torch.from_numpy(fp), torch.from_numpy(U0), 5.0, 2000)
    ref = jm.otd_evolve(jm.roessler_rhs, jnp.asarray(fp), jnp.asarray(U0), 5.0, 2000)
    for a, b in zip(got, ref):
        _close(a.numpy(), b, 1e-10)
    ly = lt.lyapunov_exponents(lt.roessler_rhs, torch.from_numpy(fp), torch.from_numpy(U0),
                               1.0, 100, n_transient=50, T_transient=0.5)
    lyj = jm.lyapunov_exponents(jm.roessler_rhs, jnp.asarray(fp), jnp.asarray(U0), 1.0, 100,
                                n_transient=50, T_transient=0.5)
    _close(ly.numpy(), lyj, 1e-10)


@pytest.mark.slow
def test_otd_fixed_point_anchor():
    """The reference anchor 0.097000856 (twice) after 20000 steps over
    T = 50 (tests/test_expm_newton.py:176-188)."""
    fp, U0 = _otd_start()
    _, _, Lr, _ = lt.otd_evolve(lt.roessler_rhs, torch.from_numpy(fp), torch.from_numpy(U0),
                                50.0, 20000)
    w = np.linalg.eigvals(Lr.numpy())
    assert np.allclose(np.sort(w.real), [0.097000856, 0.097000856], atol=1e-7)


def test_newton_options_port():
    opts = lk.NewtonOptions(maxiter=7, ifbisect=True, maxstep_bisection=3)
    assert port_options(opts) == lt.NewtonOptions(maxiter=7, ifbisect=True,
                                                   maxstep_bisection=3)
    meta = lt.NewtonMetadata(residuals=np.array([1.0, 0.1]))
    lines = []
    meta.print(lines.append)
    assert "converged=False" in lines[0]
