"""A DCGS2 step as three kernels (lightkrylov_tpu_torch.ops.gmres,
csrc/gmres.cu): its k-sized work, and its two passes over the basis, the
measurement and the rank-2 update.

On the CPU: the plain versions against the step as the solver wrote it
before the kernels (frozen below as ``_Eager`` and ``_eager_measure`` /
``_eager_update``), bit for bit at every step and in the flush; the
breakdown; the wrappers' guards and the measurement's tiles; and the
solver's choice of route (only real float32/float64 DCGS2 on a card takes
the step's kernel, and the two passes only on a basis of one tensor; forced
onto the CPU the route runs the plain versions and gives the bits of the
separate operations).  The tests marked ``cuda`` hold each kernel to its
plain version on the card, repeat it bit for bit, and run GMRES(30) cycles
through them beside the separate operations; no JAX is imported, so on a
machine with a GPU and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_gmres_fused.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import constants, vectors
from lightkrylov_tpu_torch.ops import gmres as fused
from lightkrylov_tpu_torch.utils import linalg, timer

torch.set_num_threads(2)

gmres_module = importlib.import_module("lightkrylov_tpu_torch.solvers.gmres")

KDIM = 12
N = 150
STOPS = [0, 1, KDIM // 2, KDIM - 1, "flush"]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Eager:
    """The k-sized work of a DCGS2 step as ``solvers/gmres.py`` wrote it
    before the kernel, kept here unchanged as the plain versions' yardstick:
    the tail of ``dcgs2_measure``, the loop's body and ``givens_col``."""

    def __init__(self, R, c, s, e, hist, res, tol, eps):
        kdim = R.shape[0]
        self.kdim, self.eps, self.rdt, self.dt = kdim, eps, c.dtype, R.dtype
        self.R, self.c, self.s, self.e, self.hist, self.res, self.tol = R, c, s, e, hist, res, tol
        self.Ht = R.new_zeros(kdim + 1, kdim)
        self.hp = R.new_zeros(kdim + 1)
        self.fac_prev = torch.ones((), dtype=c.dtype, device=R.device)

    @staticmethod
    def _padded(v, n):
        out = v.new_zeros((n,) + tuple(v.shape[1:]))
        out[: v.shape[0]] = v
        return out

    @staticmethod
    def _safe_inverse(a):
        ok = a > 0
        return torch.where(ok, 1.0 / torch.where(ok, a, torch.ones_like(a)),
                           torch.zeros_like(a))

    def _pythag_eta(self, sigma, z):
        eta2 = sigma - torch.vdot(z, z).real.to(self.rdt)
        eta = torch.sqrt(torch.clamp_min(eta2, 0.0))
        return eta, self._safe_inverse(eta)

    def _givens_col(self, h_col, j):
        h_col, self.c, self.s = linalg.apply_givens_rotation(h_col, self.c, self.s, j)
        self.R[:, j] = h_col[:-1]
        ej = self.e[j].clone()
        self.e[j + 1] = -self.s[j] * ej
        self.e[j] = self.c[j] * ej
        self.res = torch.abs(self.e[j + 1]).to(self.rdt)

    def step(self, PR, wTw, k, nin):
        kdim, dt, rdt, eps_r = self.kdim, self.dt, self.rdt, self.eps
        PR = self._padded(PR.to(dt), kdim + 1)
        wTw = wTw.real.to(rdt)
        sigma = PR[k, 0].real.to(rdt, copy=True)
        tau = PR[k, 1].clone()
        PR[k] = 0
        z, p = PR[:, 0], PR[:, 1]
        eta, inv_eta = self._pythag_eta(sigma, z)
        t = (tau - torch.vdot(z, p)) * inv_eta
        if k > 0:
            h_col = self.hp + z * self.fac_prev
            h_col[k] = eta * self.fac_prev
            self.Ht[:, k - 1] = h_col
        pt = p.clone()
        pt[k] = t
        self.hp = (pt - self.Ht @ z[:kdim]) * inv_eta
        gamma2 = wTw - torch.vdot(p, p).real.to(rdt) - torch.abs(t) ** 2
        gamma = torch.sqrt(torch.maximum(gamma2, eps_r * eps_r * wTw))
        inv_gamma = self._safe_inverse(gamma)
        c_q = -z * inv_eta
        c_q[k] = inv_eta
        c_u = (p - (t * inv_eta) * z) * inv_gamma
        c_u[k] = t * inv_eta * inv_gamma
        C = torch.stack([c_q, c_u], dim=1)[: k + 1]
        self.fac_prev = (gamma * inv_eta).to(rdt)
        if k > 0:
            self._givens_col(h_col, k - 1)
            self.hist[nin] = self.res
        return C, inv_gamma

    def flush(self, zf, k, nin):
        zf = self._padded(zf.to(self.dt), self.kdim + 1)
        sigma = zf[k].real.to(self.rdt, copy=True)
        zf[k] = 0
        eta, _ = self._pythag_eta(sigma, zf)
        h_col = self.hp + zf * self.fac_prev
        h_col[k] = eta * self.fac_prev
        self._givens_col(h_col, k - 1)
        self.hist[nin] = self.res


def _eager_measure(V, u_k, w, k):
    """The measurement as ``solvers/gmres.py`` wrote it before the kernels,
    kept here unchanged (without its all-reduce)."""
    Y2 = torch.stack([u_k, w])
    return vectors.innerprod_local(vectors.lead(V, k + 1), Y2), vectors.dot_local(w, w)


def _eager_update(V, k, w, C, inv_gamma):
    """The rank-2 update as ``solvers/gmres.py`` wrote it before the kernels."""
    D = vectors.linear_combination_vpu(vectors.lead(V, k + 1), C)
    u_next = vectors.axpby(inv_gamma, w, -1.0, vectors.get_column(D, 1))
    vectors.set_column(V, k, vectors.get_column(D, 0))
    vectors.set_column(V, k + 1, u_next)


class _Plain:
    """The plain versions on a :class:`fused.DCGS2State`, the solver's
    separate operations."""

    def __init__(self, *args):
        self.st = fused.DCGS2State(*args)

    def step(self, PR, wTw, k, nin):
        out = fused.dcgs2_coefficients_reference(self.st, PR, wTw, k)
        fused.dcgs2_givens_reference(self.st, k, nin)
        return out

    def flush(self, zf, k, nin):
        fused.dcgs2_flush_reference(self.st, zf, k, nin)


class _Wrapped:
    """The wrappers on a :class:`fused.FusedDCGS2`: the kernel on a card,
    the plain versions on the CPU."""

    def __init__(self, *args):
        self.st = fused.FusedDCGS2(*args)

    def step(self, PR, wTw, k, nin):
        return fused.dcgs2_step(self.st, PR, wTw, k, nin)

    def flush(self, zf, k, nin):
        fused.dcgs2_flush(self.st, zf, k, nin)


def _state(run):
    """Every tensor of the cycle's k-sized state."""
    st = getattr(run, "st", run)
    return {"Ht": st.Ht, "hp": st.hp, "fac_prev": st.fac_prev, "R": st.R, "c": st.c,
            "s": st.s, "e": st.e, "res": st.res, "hist": st.hist}


def _problem(dtype, device="cpu", seed=0):
    """A nonsymmetric well-conditioned ``A`` (N, N) and ``b``."""
    g = np.random.default_rng(seed)
    A = np.eye(N) + 0.3 * g.standard_normal((N, N)) / np.sqrt(N)
    b = g.standard_normal(N)
    return (torch.from_numpy(A).to(device=device, dtype=dtype),
            torch.from_numpy(b).to(device=device, dtype=dtype))


def _start(make, b, kdim=KDIM, tol=0.0):
    """A DCGS2 cycle on ``A x = b`` about to start, its k-sized work
    through ``make(R, c, s, e, hist, res, tol, eps)``: the run and the
    basis."""
    dt, dev = b.dtype, b.device
    beta = torch.linalg.vector_norm(b)
    V = torch.zeros(kdim + 1, b.numel(), dtype=dt, device=dev)
    V[0] = b / beta
    e = torch.zeros(kdim + 1, dtype=dt, device=dev)
    e[0] = beta
    zeros = [torch.zeros(shape, dtype=dt, device=dev) for shape in ((kdim, kdim), kdim, kdim)]
    return make(*zeros, e, torch.zeros(kdim, dtype=dt, device=dev), beta.clone(),
                torch.tensor(tol, dtype=dt, device=dev), constants.eps(dt)), V


def _measure(A, V, k):
    """Step k's measurement as the solver makes it: ``PR`` (k+1, 2), laid
    out as ``vectors.innerprod_local`` gives it, and ``w . w``."""
    u, w = V[k], A @ V[k]
    return (torch.stack([u, w]) @ V[: k + 1].mH).T, torch.vdot(w, w), w


def _advance(run, A, V, k, hook=None):
    """Step k of the cycle (``nin`` = k - 1 past the first step), the rank-2
    update of the basis included."""
    PR, wTw, w = _measure(A, V, k)
    out = run.step(PR, wTw, k, max(k - 1, 0))
    if hook is not None:
        hook(k, run, out)
    C, inv_gamma = out
    D = C.T @ V[: k + 1]
    V[k + 1] = inv_gamma * w - D[1]
    V[k] = D[0]


def _flush(run, V, kdim):
    run.flush(V[kdim] @ V[: kdim + 1].mH, kdim, kdim - 1)


def _cycle(make, A, b, kdim=KDIM, stop="flush", tol=0.0, hook=None):
    """The cycle of :func:`_start` up to step ``stop`` (``"flush"``: every
    step and the flush); ``hook(k, run, out)`` sees each step's result.
    Returns the run and the basis."""
    run, V = _start(make, b, kdim, tol)
    for k in range(kdim if stop == "flush" else stop + 1):
        _advance(run, A, V, k, hook)
    if stop == "flush":
        _flush(run, V, kdim)
    return run, V


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("stop", STOPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", [_Plain, _Wrapped])
def test_plain_step_is_the_eager_chain_bit_for_bit(form, dtype, stop):
    """Every step up to ``stop`` (and the flush) gives the bits of the
    separate operations the solver ran before: the coefficients,
    ``inv_gamma`` and the whole state."""
    A, b = _problem(dtype)
    seen, got_seen = [], []

    def recorder(into):
        return lambda k, run, out: into.append(
            (k, [t.clone() for t in out], {n: t.clone() for n, t in _state(run).items()}))

    want, Vw = _cycle(_Eager, A, b, stop=stop, hook=recorder(seen))
    got, Vg = _cycle(form, A, b, stop=stop, hook=recorder(got_seen))
    assert len(seen) == len(got_seen) == (KDIM if stop == "flush" else stop + 1)
    for (k, out_w, st_w), (_, out_g, st_g) in zip(seen, got_seen):
        assert all(torch.equal(a, b_) for a, b_ in zip(out_w, out_g)), k
        for name in st_w:
            assert torch.equal(st_w[name], st_g[name]), (k, name)
    for name, t in _state(want).items():
        assert torch.equal(t, _state(got)[name]), name
    assert torch.equal(Vw, Vg)
    if stop == "flush":
        assert float(_state(got)["res"]) < float(torch.linalg.vector_norm(b))


def _breakdown_measurement(k, dtype, device):
    """A measurement of step ``k`` whose ``u_k`` lies in the span of the
    filled columns: ``sigma`` is exactly ``z . z`` (dyadic entries)."""
    z = torch.tensor([0.5, -0.25, 0.75, 0.125][:k] + [0.0] * max(0, k - 4),
                     dtype=dtype, device=device)
    p = torch.linspace(-1.0, 1.0, k + 1, dtype=dtype, device=device)
    PR = torch.stack([torch.cat([z, (z @ z).reshape(1)]), p], dim=1)
    return PR, torch.tensor(3.0, dtype=dtype, device=device)


def _breakdown(form, dtype, device, k=3):
    A, b = _problem(dtype, device)
    run, _ = _cycle(form, A, b, stop=k - 1, tol=1e-30)
    PR, wTw = _breakdown_measurement(k, dtype, device)
    C, inv_gamma = run.step(PR, wTw, k, k - 1)
    st = run.st
    return C, st


@pytest.mark.parametrize("form", [_Plain, _Wrapped])
def test_breakdown_writes_a_zero_column_and_ends_the_recursion(form):
    """eta = 0: the corrected q_k is exactly zero, ``hp`` is zero, the
    finished column's subdiagonal vanishes, so the rotation leaves a zero
    residual and the flag reads false."""
    C, st = _breakdown(form, torch.float64, "cpu")
    assert bool((C[:, 0] == 0).all()) and bool((st.hp == 0).all())
    assert float(st.Ht[3, 2]) == 0.0 and float(st.s[2]) == 0.0
    assert float(st.res) == 0.0 and float(st.e[3]) == 0.0
    assert not bool(st.flag) and bool(st.conv)


def _bound(dtype=torch.float64, kdim=4, V=None, **change):
    t = {"R": torch.zeros(kdim, kdim, dtype=dtype), "c": torch.zeros(kdim, dtype=dtype),
         "s": torch.zeros(kdim, dtype=dtype), "e": torch.zeros(kdim + 1, dtype=dtype),
         "hist": torch.zeros(8, dtype=dtype), "res": torch.tensor(1.0, dtype=dtype),
         "tol": torch.tensor(0.0, dtype=dtype)}
    t.update(change)
    return fused.FusedDCGS2(*t.values(), constants.eps(dtype), V=V)


def test_wrappers_check_their_tensors():
    with pytest.raises(TypeError, match="not supported"):
        _bound(torch.complex128)
    with pytest.raises(ValueError, match="kdim"):
        _bound(kdim=fused.MAX_KDIM + 1)
    with pytest.raises(ValueError, match="shape"):
        _bound(e=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="float64"):
        _bound(c=torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        _bound(R=torch.zeros(4, 4, dtype=torch.float64).T)
    st = _bound()
    PR, wTw = torch.zeros(2, 2, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="measurement"):
        fused.dcgs2_step(st, PR, wTw, 0, 0)  # step 0 measures one row
    with pytest.raises(ValueError, match="measurement"):
        fused.dcgs2_step(st, PR.float(), wTw, 1, 0)
    with pytest.raises(IndexError):
        fused.dcgs2_step(st, torch.zeros(5, 2, dtype=torch.float64), wTw, 4, 0)
    with pytest.raises(IndexError, match="history"):
        fused.dcgs2_step(st, PR, wTw, 1, 8)
    with pytest.raises(IndexError):
        fused.dcgs2_flush(st, torch.zeros(1, dtype=torch.float64), 0, 0)


PASS_KDIM = 30
PASS_STEPS = [0, 1, 6, 11, 29]


def _basis(dtype, kdim=PASS_KDIM, shape=(7, 5), device="cpu", seed=0, offset=0):
    """A basis of ``kdim + 1`` seeded fields of ``shape`` and a field ``w``;
    with ``offset`` the basis starts that many elements into its storage."""
    g = np.random.default_rng(seed)
    flat = torch.from_numpy(g.standard_normal(offset + (kdim + 1) * int(np.prod(shape))))
    V = flat.to(device=device, dtype=dtype)[offset:].view(kdim + 1, *shape)
    w = torch.from_numpy(g.standard_normal(shape)).to(device=device, dtype=dtype)
    return V, w


def _coefficients(k, dtype, device="cpu"):
    """Seeded rank-2 coefficients (k+1, 2) and an ``inv_gamma``."""
    C = torch.from_numpy(np.random.default_rng(100 + k).standard_normal((k + 1, 2)))
    return C.to(device=device, dtype=dtype), torch.tensor(0.75, dtype=dtype, device=device)


@pytest.mark.parametrize("k", PASS_STEPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_passes_are_the_eager_sequence_bit_for_bit(dtype, k):
    """The plain measurement and rank-2 update give the bits of the
    separate operations the solver ran before the kernels; so do the
    wrappers on the CPU, the measurement in one buffer."""
    V, w = _basis(dtype)
    PR, wTw = fused.dcgs2_measure_reference(V, k, w)
    want_PR, want_wTw = _eager_measure(V, V[k], w, k)
    assert torch.equal(PR, want_PR) and torch.equal(wTw, want_wTw)
    C, inv_gamma = _coefficients(k, dtype)
    got, want = V.clone(), V.clone()
    fused.dcgs2_update_reference(got, k, w, C, inv_gamma)
    _eager_update(want, k, w, C, inv_gamma)
    assert torch.equal(got, want)
    st = _bound(dtype, kdim=PASS_KDIM, V=V.clone())
    m = fused.dcgs2_measure(st, k, w)
    assert m.shape == (2 * k + 3,)
    assert torch.equal(m[:-1].view(k + 1, 2), want_PR) and torch.equal(m[-1], want_wTw)
    st.coeff, st.inv_gamma = C, inv_gamma
    fused.dcgs2_update(st, k, w)
    assert torch.equal(st.V, want)


def test_basis_wrappers_check_their_tensors():
    V, w = _basis(torch.float64, kdim=4)
    with pytest.raises(ValueError, match="without a basis"):
        fused.dcgs2_measure(_bound(), 0, w)
    with pytest.raises(ValueError, match="shape"):
        _bound(V=V[:4])
    with pytest.raises(ValueError, match="basis is torch.float32"):
        _bound(V=V.float())
    with pytest.raises(ValueError, match="contiguous"):
        _bound(V=V.transpose(1, 2))
    st = _bound(V=V)
    with pytest.raises(IndexError, match="step 4"):
        fused.dcgs2_measure(st, 4, w)
    with pytest.raises(ValueError, match="operator gave"):
        fused.dcgs2_measure(st, 0, w.reshape(-1))
    with pytest.raises(ValueError, match="operator gave"):
        fused.dcgs2_update(st, 0, w.float())
    with pytest.raises(RuntimeError, match="no coefficients"):
        fused.dcgs2_update(st, 0, w)


def _gmres(dtype, orth="dcgs2", flexible=False, preconditioner=None, device="cpu", n=24,
           maxiter=3, kdim=KDIM, leaves=None):
    """GMRES on the Poisson operator; with ``leaves`` on a dict of that many
    fields (the operator applied to each, the second scaled)."""
    op = (lt.CudaPoisson2D(n, dtype=dtype, device=device) if torch.device(device).type == "cuda"
          else lt.Poisson2D(n, dtype=dtype))
    g = np.random.default_rng(5)
    b = torch.from_numpy(g.standard_normal((n, n))).to(dtype=torch.float64)
    if dtype.is_complex:
        b = torch.complex(b, torch.from_numpy(g.standard_normal((n, n))))
    b = b.to(device=device, dtype=dtype)
    if leaves is not None:
        names = "ab"[:leaves]
        b = {name: b * (i + 1) for i, name in enumerate(names)}
        grid = op
        op = lt.MatvecOperator(lambda x: {name: grid.matvec(x[name]) * (i + 1)
                                          for i, name in enumerate(names)})
    solver = lt.fgmres if flexible else lt.gmres
    opts = lt.GMRESOptions(kdim=kdim, maxiter=maxiter, orthogonalization=orth)
    return solver(op, b, rtol=0.0, atol=0.0, options=opts, preconditioner=preconditioner)


class _Halving(lt.Preconditioner):
    def apply(self, v, iteration=0, current_residual=0.0, target_residual=0.0):
        return 0.5 * v


ROUTES = {"f32": dict(dtype=torch.float32), "f64": dict(dtype=torch.float64),
          "preconditioned": dict(dtype=torch.float64, preconditioner=_Halving()),
          "complex": dict(dtype=torch.complex128), "cgs2": dict(dtype=torch.float64, orth="cgs2"),
          "fgmres": dict(dtype=torch.float64, flexible=True),
          "one_leaf": dict(dtype=torch.float32, leaves=1),
          "two_leaves": dict(dtype=torch.float64, leaves=2)}
TAKES_KERNEL = {"f32", "f64", "preconditioned", "one_leaf", "two_leaves"}
#: the routes whose basis is one tensor: the two passes take their kernels too
TAKES_BASIS = TAKES_KERNEL - {"two_leaves"}
#: every kernel a DCGS2 GMRES solve may launch
DCGS2_KERNELS = ("dcgs2_step", "dcgs2_flush", "dcgs2_measure", "dcgs2_update")


def _on_a_card(monkeypatch):
    """Make the solver's route test take the CPU for a card."""
    fits = gmres_module._fits_fused
    monkeypatch.setattr(gmres_module, "_fits_fused",
                        lambda dt, dev, kdim: fits(dt, torch.device("cuda"), kdim))


def _steps():
    return timer.get_counter("gmres.fused_steps")


def _basis_steps():
    return timer.get_counter("gmres.fused_basis_steps")


def _same(a, b):
    (xa, ia, ma), (xb, ib, mb) = a, b
    xa, xb = (x if isinstance(x, dict) else {"": x} for x in (xa, xb))
    return (xa.keys() == xb.keys() and all(torch.equal(xa[n], xb[n]) for n in xa) and ia == ib
            and np.array_equal(ma.residuals, mb.residuals))


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_selection(case, monkeypatch):
    """On the CPU no route takes the kernel and none counts a fused step.
    Told the CPU is a card, the real DCGS2 routes run the wrappers (the
    plain versions here), count kdim steps a cycle, and give the bits of the
    separate operations; complex vectors, CGS2 and FGMRES stay on them."""
    kw = ROUTES[case]
    before, basis_before = _steps(), _basis_steps()
    natural = _gmres(**kw)
    assert _steps() == before and _basis_steps() == basis_before
    _on_a_card(monkeypatch)
    launches = [_launches(name) for name in DCGS2_KERNELS]
    forced = _gmres(**kw)
    assert _steps() - before == (3 * KDIM if case in TAKES_KERNEL else 0)
    assert _basis_steps() - basis_before == (3 * KDIM if case in TAKES_BASIS else 0)
    assert [_launches(name) for name in DCGS2_KERNELS] == launches
    assert _same(natural, forced)


def test_forced_route_stops_where_the_separate_operations_stop(monkeypatch):
    """A solve that converges inside a cycle reads the same flags, at the
    same steps, on both routes."""
    def solve():
        op = lt.Poisson2D(16, dtype=torch.float64)
        b = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 16)))
        return lt.gmres(op, b, rtol=1e-6, atol=0.0, options=lt.GMRESOptions(kdim=20, maxiter=10))

    timer.reset_counters()
    natural = solve()
    reads = timer.get_counter("host_reads")
    _on_a_card(monkeypatch)
    timer.reset_counters()
    forced = solve()
    assert forced[1] > 0 and forced[2].converged and _same(natural, forced)
    assert timer.get_counter("host_reads") == reads
    # full cycles step kdim times; the last stops one step past its columns
    assert _steps() == forced[1] + 1


#: The counters a fused GMRES solve moves: on a card its launches too
FUSED_COUNTERS = ("gmres.fused_steps", "gmres.fused_basis_steps", "host_reads",
                  *(f"launches.{name}" for name in DCGS2_KERNELS), "launches.stencil_matvec")


def _counts_with_timing(**kw):
    """The fused route's counters over one solve with timing off, then on."""
    counts = []
    for on in (False, True):
        timer.reset_counters()
        lt.set_timing(on)
        try:
            _gmres(torch.float32, **kw)
        finally:
            lt.set_timing(False)
        counts.append({name: timer.get_counter(name) for name in FUSED_COUNTERS})
    return counts


def test_timing_changes_neither_fused_steps_nor_reads(monkeypatch):
    _on_a_card(monkeypatch)
    off, on = _counts_with_timing()
    assert off == on and off["gmres.fused_steps"] == off["gmres.fused_basis_steps"] == 3 * KDIM
    assert off["host_reads"] > 0
    assert all(off[f"launches.{name}"] == 0 for name in DCGS2_KERNELS)


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_reset_counters_clears_the_launch_counts(where, monkeypatch):
    """``reset_counters()`` clears the ``launches.*`` counts with the others.
    On the CPU the route is forced and counts its steps and reads but no
    launch; on a card the solve counts a launch a step, one a flush and one a
    matvec."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if where == "cpu":
        _on_a_card(monkeypatch)
    timer.reset_counters()
    _gmres(torch.float32, device=where)
    moved = {name: timer.get_counter(name) for name in FUSED_COUNTERS}
    on_card = where == "cuda"
    assert moved["gmres.fused_steps"] == moved["gmres.fused_basis_steps"] == 3 * KDIM
    assert moved["host_reads"] > 0
    for name in ("dcgs2_step", "dcgs2_measure", "dcgs2_update"):
        assert moved[f"launches.{name}"] == (3 * KDIM if on_card else 0), name
    assert moved["launches.dcgs2_flush"] == (3 if on_card else 0)
    assert (moved["launches.stencil_matvec"] >= 3 * KDIM) == on_card
    timer.reset_counters()
    assert all(timer.get_counter(name) == 0 for name in FUSED_COUNTERS)


# -- on the GPU ------------------------------------------------------------------

TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
KERNEL_KDIM = 30


def _rel(got, want):
    scale = float(torch.linalg.norm(want.double()))
    err = float(torch.linalg.norm((got - want).double()))
    return err if scale == 0 else err / scale


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [0, 1, KERNEL_KDIM // 2, KERNEL_KDIM - 1, "flush"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(cuda, dtype, stop):
    """One launch against the plain version on the card, from the same state
    and measurement: the coefficients and every tensor of the state within
    1e-6 (f32) / 1e-13 (f64) of their norms, the flags equal."""
    A, b = _problem(dtype, cuda, seed=1)
    k_stop = KERNEL_KDIM if stop == "flush" else stop
    plain, V = _start(_Plain, b, KERNEL_KDIM)
    for k in range(k_stop):
        _advance(plain, A, V, k)
    st = plain.st
    bound = fused.FusedDCGS2(*(t.clone() for t in (st.R, st.c, st.s, st.e, st.hist)),
                             st.res.clone(), st.tol.clone(), st.eps)
    bound.Ht.copy_(st.Ht)
    bound.hp.copy_(st.hp)
    bound.fac_prev.copy_(st.fac_prev)
    nin = max(k_stop - 1, 0)
    if stop == "flush":
        zf = V[k_stop] @ V[: k_stop + 1].mH
        fused.dcgs2_flush(bound, zf, k_stop, nin)
        plain.flush(zf, k_stop, nin)
        outs = ()
    else:
        PR, wTw, _ = _measure(A, V, k_stop)
        # the same step on a copy, from a row-major measurement, as an
        # all-reduce over a reduction group leaves it: the same bits
        twin = fused.FusedDCGS2(*(t.clone() for t in (bound.R, bound.c, bound.s, bound.e,
                                                     bound.hist)),
                                st.res.clone(), st.tol.clone(), st.eps)
        twin.work.copy_(bound.work)
        before = _launches("dcgs2_step")
        C1, g1 = fused.dcgs2_step(bound, PR, wTw, k_stop, nin)
        C3, g3 = fused.dcgs2_step(twin, PR.contiguous(), wTw, k_stop, nin)
        C2, g2 = plain.step(PR, wTw, k_stop, nin)
        assert _launches("dcgs2_step") == before + 2
        assert torch.equal(C1, C3) and torch.equal(g1, g3) and torch.equal(bound.work, twin.work)
        outs = ((C1, C2), (g1, g2))
    torch.cuda.synchronize()
    rel = TOL[dtype]
    for got, want in outs:
        assert _rel(got, want) <= rel
    got_state, want_state = _state(bound), _state(plain.st)
    for name in want_state:
        assert _rel(got_state[name], want_state[name]) <= rel, name
    assert bool(bound.flag) == bool(plain.st.flag) and bool(bound.conv) == bool(plain.st.conv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_cycles_are_bit_equal(cuda, dtype):
    A, b = _problem(dtype, cuda, seed=2)
    (r1, V1), (r2, V2) = (_cycle(_Wrapped, A, b, kdim=KERNEL_KDIM) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(V1, V2)
    for name, t in _state(r1).items():
        assert torch.equal(t, _state(r2)[name]), name
    assert torch.equal(r1.st.coeff, r2.st.coeff)


@pytest.mark.cuda
def test_cuda_kernel_cycle_follows_the_plain_cycle(cuda):
    """A whole f64 cycle through the kernel against the plain versions."""
    A, b = _problem(torch.float64, cuda, seed=3)
    (kr, Vk), (pr, Vp) = (_cycle(f, A, b, kdim=KERNEL_KDIM) for f in (_Wrapped, _Plain))
    torch.cuda.synchronize()
    assert _rel(Vk, Vp) <= 1e-11
    for name, t in _state(pr).items():
        assert _rel(_state(kr)[name], t) <= 1e-11, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_breakdown(cuda, dtype):
    C, st = _breakdown(_Wrapped, dtype, cuda)
    torch.cuda.synchronize()
    assert bool((C[:, 0] == 0).all()) and bool((st.hp == 0).all())
    assert float(st.Ht[3, 2]) == 0.0 and float(st.s[2]) == 0.0
    assert float(st.res) == 0.0 and not bool(st.flag) and bool(st.conv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_gmres_cycle_matches_the_separate_operations(cuda, dtype, monkeypatch):
    """GMRES(30) cycles on the card through the kernel against the same
    cycles by separate operations: the iterate and the residual history
    within 1e-3, the same host reads, 30 fused steps and one flush a cycle."""
    runs = {}
    for route in ("kernel", "separate"):
        if route == "separate":
            monkeypatch.setattr(gmres_module, "_fits_fused", lambda *args: False)
        timer.reset_counters()
        x, info, meta = _gmres(dtype, device=cuda, n=256, maxiter=2, kdim=KERNEL_KDIM)
        runs[route] = dict(x=x, meta=meta, reads=timer.get_counter("host_reads"), steps=_steps(),
                           basis_steps=_basis_steps(),
                           launches=tuple(_launches(name) for name in DCGS2_KERNELS))
    k, s = runs["kernel"], runs["separate"]
    steps = 2 * KERNEL_KDIM
    assert k["steps"] == k["basis_steps"] == steps and k["launches"] == (steps, 2, steps, steps)
    assert s["steps"] == s["basis_steps"] == 0 and s["launches"] == (0, 0, 0, 0)
    # a cycle's reads: the outer test, a flag a step and the last flag; one fetch at the end
    assert k["reads"] == s["reads"] == 2 * (KERNEL_KDIM + 2) + 1
    assert _rel(k["x"], s["x"]) <= 1e-3
    hk, hs = k["meta"].residuals, s["meta"].residuals
    assert hk.shape == hs.shape and np.linalg.norm(hk - hs) <= 1e-3 * np.linalg.norm(hs)


def _fresh(V):
    """A :class:`fused.FusedDCGS2` of zeros bound to the basis ``V``."""
    kdim, dt, dev = V.shape[0] - 1, V.dtype, V.device

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return fused.FusedDCGS2(z(kdim, kdim), z(kdim), z(kdim), z(kdim + 1), z(kdim),
                            torch.ones((), dtype=dt, device=dev), z(), constants.eps(dt), V=V)


def _passes_against_plain(V, k, w, C, inv_gamma):
    """The two kernels at step ``k`` on two copies of ``V`` against the plain
    versions run in float64 on the same inputs: the float32 plain
    measurement's cuBLAS product is itself up to 1.7e-6 from float64 at
    3162^2 (the kernel's sums, ~1e-7), so float64 is the yardstick both are
    held to.  Then the plain versions update ``V`` as a cycle does.
    Returns the largest gap of the measurement (each dot against the
    product of its two vectors' norms), the largest of the two columns the
    update writes (against their norms), and whether the copies agree bit
    for bit, the update writing in place and leaving every other column
    alone."""
    copies = [V.clone(), V.clone()]
    states = [_fresh(c) for c in copies]
    ms = [fused.dcgs2_measure(st, k, w).clone() for st in states]
    V64, w64 = V.to(torch.float64, copy=True), w.to(torch.float64, copy=True)
    PR, wTw = fused.dcgs2_measure_reference(V64, k, w64)
    norms = torch.linalg.vector_norm(V64[: k + 1].reshape(k + 1, -1), dim=1)
    w_norm = torch.linalg.vector_norm(w64)
    scale = norms[:, None] * torch.stack([norms[k], w_norm])[None, :]
    gap_m = max(float(((ms[0][:-1].view(k + 1, 2).double() - PR).abs() / scale).max()),
                abs(float(ms[0][-1]) - float(wTw)) / float(w_norm) ** 2)
    for st in states:
        st.coeff[: k + 1] = C
        st.inv_gamma.copy_(inv_gamma)
        fused.dcgs2_update(st, k, w)
    fused.dcgs2_update_reference(V64, k, w64, C.double(), inv_gamma.double())
    fused.dcgs2_update_reference(V, k, w, C, inv_gamma)
    torch.cuda.synchronize()
    got = copies[0]
    gap_u = max(_rel(got[k].double(), V64[k]), _rel(got[k + 1].double(), V64[k + 1]))
    same = (torch.equal(ms[0], ms[1]) and torch.equal(copies[0], copies[1])
            and all(st.V.data_ptr() == c.data_ptr() for st, c in zip(states, copies))
            and torch.equal(got[:k], V[:k]) and torch.equal(got[k + 2:], V[k + 2:]))
    return gap_m, gap_u, same


BASIS_N = 3162


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_basis_kernels_match_plain_at_every_step(cuda, dtype):
    """At every step of a GMRES(30) cycle on the 3162^2 stencil, run by the
    plain versions, the measurement and the rank-2 update kernels against
    them within 1e-6 (f32) / 1e-13 (f64), bit-equal when repeated, ``V[k]``
    and ``V[k+1]`` written in place."""
    n = BASIS_N
    op = lt.CudaPoisson2D(n, dtype=dtype, device=cuda)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(n * n))
    plain, V = _start(_Plain, b.to(device=cuda, dtype=dtype), KERNEL_KDIM)
    for k in range(KERNEL_KDIM):
        w = op.matvec(V[k].view(n, n)).reshape(-1)
        PR, wTw = fused.dcgs2_measure_reference(V, k, w)
        C, inv_gamma = plain.step(PR, wTw, k, max(k - 1, 0))
        gap_m, gap_u, same = _passes_against_plain(V, k, w, C, inv_gamma)
        assert gap_m <= TOL[dtype] and gap_u <= TOL[dtype], (k, gap_m, gap_u)
        assert same, k


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 8, 16, 31, 32, 33, 64, 127])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_basis_kernels_at_kdim_128(cuda, dtype, k):
    """kdim 128: the measurement over several column tiles."""
    V, w = _basis(dtype, kdim=128, shape=(65536,), device=cuda, seed=k)
    gap_m, gap_u, same = _passes_against_plain(V, k, w, *_coefficients(k, dtype, cuda))
    assert gap_m <= TOL[dtype] and gap_u <= TOL[dtype] and same


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((1001 * 999,), 0), ((65536,), 1)],
                         ids=["odd_n", "offset_basis"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_basis_kernels_unaligned(cuda, dtype, shape, offset):
    """Columns that are not 16-byte aligned take the scalar instances."""
    V, w = _basis(dtype, shape=shape, device=cuda, offset=offset)
    for k in (0, 5, PASS_KDIM - 1):
        gap_m, gap_u, same = _passes_against_plain(V, k, w, *_coefficients(k, dtype, cuda))
        assert gap_m <= TOL[dtype] and gap_u <= TOL[dtype] and same, k


@pytest.mark.cuda
def test_cuda_timing_changes_no_fused_count(cuda):
    """On the card the launches, steps and reads of a solve are the same
    with timing off and on."""
    off, on = _counts_with_timing(device=cuda)
    assert off == on and off["launches.dcgs2_measure"] == off["launches.dcgs2_update"] == 3 * KDIM
