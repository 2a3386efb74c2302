"""Checkpoints: the port's ``save_checkpoint``/``load_checkpoint`` against
the JAX package's file layout, and checkpoint/resume in ``eigs``,
``eighs`` and ``svds``.

An interrupted run that is resumed from its checkpoint repeats the
uninterrupted run: the same ``n_iter`` (restored cumulatively, so equality
shows the same trajectory step for step) and the same eigen- or singular
values within 1e-10 absolute, as in tests/test_eigensolvers.py:265-351.  A
solver state written by the JAX package resumes in the port, and one written
by the port resumes in the JAX package, with the same outcome within the
same 1e-10 (the two packages differ by a few roundings per step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import TridiagToeplitz as JToeplitz
from lightkrylov_tpu.utils import checkpoint as jckpt
from lightkrylov_tpu_torch.convert import port_operator, port_options

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


TOL = 1e-10
N = 60


def _state(xp):
    """A nested state with tensors of four dtypes, a 0-d leaf, a scalar
    counter and a None, built with ``xp`` (torch or jnp)."""
    rng = np.random.default_rng(0)
    arr = (lambda a: torch.from_numpy(np.asarray(a))) if xp is torch else jnp.asarray
    return {"X": arr(rng.standard_normal((3, 4)).astype(np.float32)),
            "H": arr(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))),
            "kstart": np.int64(5),
            "tree": {"pos": arr(rng.standard_normal(3)), "T": arr(np.float64(6.0))},
            "blocks": [arr(np.arange(4, dtype=np.int32)), (arr(np.ones(2, np.complex64)), None)]}


def _leaves(tree):
    from lightkrylov_tpu_torch.utils.checkpoint import _flatten_with_paths
    return [np.asarray(leaf) for _, leaf in _flatten_with_paths(tree)]


def test_checkpoint_roundtrip(tmp_path):
    state = _state(torch)
    path = str(tmp_path / "state.npz")
    lt.save_checkpoint(state, path)
    template = {"X": torch.zeros(3, 4), "H": torch.zeros(2, 2, dtype=torch.complex128),
                "kstart": np.int64(0),
                "tree": {"pos": torch.zeros(3, dtype=torch.float64), "T": torch.zeros(())},
                "blocks": [torch.zeros(4), (torch.zeros(2), None)]}
    back = lt.load_checkpoint(template, path)
    assert list(back) == list(state) and back["blocks"][1][1] is None
    assert isinstance(back["X"], torch.Tensor) and isinstance(back["kstart"], np.ndarray)
    for a, b in zip(_leaves(back), _leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        lt.load_checkpoint({"X": torch.zeros(3, 4)}, path)


def test_checkpoint_layout_matches_jax(tmp_path):
    """The same keys, in the same order, as the JAX package writes."""
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lt.save_checkpoint(_state(torch), pt)
    jckpt.save_checkpoint(_state(jnp), pj)
    with np.load(pt) as ft, np.load(pj) as fj:
        assert sorted(ft.files) == sorted(fj.files)
        for k in fj.files:
            assert ft[k].dtype == fj[k].dtype and np.array_equal(ft[k], fj[k])


def test_checkpoint_crosses_packages(tmp_path):
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lt.save_checkpoint(_state(torch), pt)
    jckpt.save_checkpoint(_state(jnp), pj)
    for a, b in zip(_leaves(lt.load_checkpoint(_state(torch), pj)), _leaves(_state(torch))):
        assert np.array_equal(a, b)
    for a, b in zip(_leaves(jckpt.load_checkpoint(_state(jnp), pt)), _leaves(_state(torch))):
        assert np.array_equal(a, b)


# -- solver checkpoint/resume -------------------------------------------------

def _rotation_op(seed=0):
    """A real normal operator with conjugate pairs r_i e^{+-i theta_i},
    moduli decaying geometrically (tests/test_eigensolvers.py:73-91)."""
    rng = np.random.default_rng(seed)
    r = 2.0 * 0.7 ** np.arange(N // 2)
    theta = rng.uniform(0.2, np.pi - 0.2, N // 2)
    A = np.zeros((N, N))
    for i, (ri, ti) in enumerate(zip(r, theta)):
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] = ri * np.array([[np.cos(ti), -np.sin(ti)],
                                                            [np.sin(ti), np.cos(ti)]])
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return lk.DenseOperator(jnp.asarray(Q @ A @ Q.T))


def _geometric(seed=31):
    rng = np.random.default_rng(seed)
    sv = 3.0 * 0.8 ** np.arange(N // 2)
    Um, _ = np.linalg.qr(rng.standard_normal((N, N // 2)))
    Vm, _ = np.linalg.qr(rng.standard_normal((N // 2, N // 2)))
    return lk.DenseOperator(jnp.asarray((Um * sv) @ Vm.T))


def _x0(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


# Each case: the solver, its operator, start vector and keyword arguments,
# the maxiter of the full run and of the interrupted one; the JAX tests'
# configurations (test_eigensolvers.py:265-351)
CASES = {
    "eigs": dict(solver="eigs", op=_rotation_op, nev=4, x0=lambda: _x0(N, 3),
                 kw=dict(kdim=12, tolerance=1e-9), full=60, cut=2),
    "eigs-check-every-4": dict(solver="eigs", op=_rotation_op, nev=4, x0=lambda: _x0(N, 3),
                               kw=dict(kdim=12, tolerance=1e-9, check_every=4), full=60, cut=1),
    "eighs": dict(solver="eighs", op=lambda: JToeplitz(N, 4.0, -1.0), nev=6,
                  x0=lambda: _x0(N, 9), kw=dict(kdim=32, tolerance=1e-9), full=80, cut=2),
    "eighs-c128": dict(solver="eighs", op=lambda: JToeplitz(N, 4.0, -1.0, dtype=jnp.complex128),
                       nev=6, x0=lambda: _x0(N, 9, np.complex128), kw=dict(kdim=32, tolerance=1e-9),
                       full=80, cut=2),
    # maxiter=1 has no restart boundary: check_every=4 gives sweep boundaries
    "svds": dict(solver="svds", op=_geometric, nev=4, x0=lambda: _x0(N, 6),
                 kw=dict(kdim=12, tolerance=1e-9, v_template=np.zeros(N // 2)), full=40, cut=1,
                 cut_kw=dict(check_every=4)),
}


def _options(pkg, d, **kw):
    return (pkg.SVDSOptions if d["solver"] == "svds" else pkg.EigsOptions)(**kw)


def _run(pkg, d, op, x0, path=None, maxiter=None, resume_from=None, extra=None):
    """One call of the solver case ``d`` in ``pkg`` (``lk`` or ``lt``); returns
    ``(values, metadata)``."""
    arr = jnp.asarray if pkg is lk else torch.from_numpy
    kw = {k: (arr(v) if isinstance(v, np.ndarray) else v) for k, v in d["kw"].items()}
    kw.update(extra or {})
    opts = _options(pkg, d, maxiter=maxiter or d["full"],
                    **(dict(checkpoint_every=1, checkpoint_path=path) if path else {}))
    if d["solver"] == "svds":
        out = pkg.svds(op, d["nev"], u0=arr(x0), options=opts, resume_from=resume_from, **kw)
        return np.asarray(out[1]), out[5]
    out = getattr(pkg, d["solver"])(op, d["nev"], x0=arr(x0), options=opts,
                                    resume_from=resume_from, **kw)
    return np.asarray(out[0]), out[4]


def _interrupt(pkg, d, op, x0, path):
    _, meta = _run(pkg, d, op, x0, path=path, maxiter=d["cut"], extra=d.get("cut_kw"))
    assert not meta.converged  # genuinely interrupted
    with np.load(path) as f:
        assert len(f.files) == 6 if d["solver"] == "svds" else len(f.files) == 5


def _same(a, b):
    (wa, ma), (wb, mb) = a, b
    assert ma.converged and mb.converged and ma.n_iter == mb.n_iter
    assert np.abs(wa - wb).max() <= TOL


@pytest.mark.parametrize("case", list(CASES))
def test_resume_repeats_the_uninterrupted_run(case, tmp_path):
    d = CASES[case]
    op, x0 = port_operator(d["op"]()), d["x0"]()
    full = _run(lt, d, op, x0)
    path = str(tmp_path / "ckpt.npz")
    _interrupt(lt, d, op, x0, path)
    _same(_run(lt, d, op, x0, resume_from=path), full)


@pytest.mark.parametrize("case", ["eigs", "eighs", "svds"])
def test_a_jax_checkpoint_resumes_in_the_port(case, tmp_path):
    d = CASES[case]
    op_j, x0 = d["op"](), d["x0"]()
    full = _run(lk, d, op_j, x0)
    path = str(tmp_path / "jax.npz")
    _interrupt(lk, d, op_j, x0, path)
    _same(_run(lt, d, port_operator(op_j), x0, resume_from=path), full)


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    d = CASES["svds"]
    op_j, x0 = d["op"](), d["x0"]()
    full = _run(lk, d, op_j, x0)
    path = str(tmp_path / "port.npz")
    _interrupt(lt, d, port_operator(op_j), x0, path)
    _same(_run(lk, d, op_j, x0, resume_from=path), full)


def test_checkpoint_cadence_and_options(tmp_path):
    """Nothing is written without a path or with checkpoint_every=0, and a
    missing resume file is an error."""
    d = CASES["eigs"]
    op, x0 = port_operator(d["op"]()), d["x0"]()
    lt.eigs(op, 4, x0=torch.from_numpy(x0), kdim=12, tolerance=1e-9,
            options=lt.EigsOptions(maxiter=2, checkpoint_every=1))
    lt.eigs(op, 4, x0=torch.from_numpy(x0), kdim=12, tolerance=1e-9,
            options=lt.EigsOptions(maxiter=2, checkpoint_path=str(tmp_path / "never.npz")))
    assert not list(tmp_path.iterdir())
    with pytest.raises(FileNotFoundError):
        lt.eigs(op, 4, x0=torch.from_numpy(x0), resume_from=str(tmp_path / "missing.npz"))
    opts = lk.EigsOptions(checkpoint_every=3, checkpoint_path="a.npz")
    assert port_options(opts) == lt.EigsOptions(checkpoint_every=3, checkpoint_path="a.npz")
