"""Parity of lightkrylov_tpu_torch.vectors with lightkrylov_tpu.vectors.

The same inputs, made with numpy from a seed, go through both packages in
the four dtypes; the tolerance is ``constants.rtol`` of the dtype relative
to the norm of the JAX result.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu import constants as jconstants
from lightkrylov_tpu import vectors as jv
from lightkrylov_tpu_torch import vectors as tv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

K, SHAPE = 5, (6, 7)


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _inputs(dtype, seed=0):
    """A pytree basis (two leaves), a vector and a 2-column block."""
    rng = np.random.default_rng(seed)
    X = {"u": _rand(rng, (K,) + SHAPE, dtype), "w": _rand(rng, (K, 9), dtype)}
    y = {"u": _rand(rng, SHAPE, dtype), "w": _rand(rng, (9,), dtype)}
    Y = {"u": _rand(rng, (2,) + SHAPE, dtype), "w": _rand(rng, (2, 9), dtype)}
    return X, y, Y


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got, ref, dtype):
    got = np.concatenate([np.ravel(np.asarray(g)) for g in
                          (got.values() if isinstance(got, dict) else [got])])
    ref = np.concatenate([np.ravel(np.asarray(r)) for r in
                          (ref.values() if isinstance(ref, dict) else [ref])])
    assert got.dtype == ref.dtype
    tol = jconstants.rtol(dtype) * max(np.linalg.norm(ref), 1e-300)
    assert np.linalg.norm(got - ref) <= tol, np.linalg.norm(got - ref) / tol


def _np(tree):
    if isinstance(tree, dict):
        return {k: v.numpy() for k, v in tree.items()}
    return tree.numpy()


def test_vector_algebra(dtype):
    X, y, _ = _inputs(dtype)
    x = {k: v[0] for k, v in X.items()}
    a, b = dtype(0.7 - 0.2j) if np.iscomplexobj(dtype(0)) else dtype(0.7), dtype(-1.3)
    _close(tv.dot(_t(x), _t(y)).numpy(), np.asarray(jv.dot(_j(x), _j(y))), dtype)
    _close(tv.norm(_t(x)).numpy(), np.asarray(jv.norm(_j(x))), dtype)
    _close(tv.norm(_t(x)["u"]).numpy(), np.asarray(jv.norm(_j(x)["u"])), dtype)
    _close(_np(tv.scal(a, _t(x))), jv.scal(a, _j(x)), dtype)
    _close(_np(tv.axpby(a, _t(x), b, _t(y))), jv.axpby(a, _j(x), b, _j(y)), dtype)
    _close(_np(tv.add(_t(x), _t(y))), jv.add(_j(x), _j(y)), dtype)
    zero = tv.zero_like(_t(x))
    assert all(not v.any() for v in zero.values())
    assert tv.dtype_of(_t(x)) == lt.constants.as_torch_dtype(dtype)


def test_basis_columns(dtype):
    X, y, _ = _inputs(dtype)
    Xt = _t(X)
    assert tv.basis_size(Xt) == K == jv.basis_size(_j(X))
    _close(_np(tv.get_column(Xt, 2)), jv.get_column(_j(X), 2), dtype)
    ref = jv.set_column(_j(X), 3, _j(y))
    out = tv.set_column(Xt, 3, _t(y))
    assert out is Xt  # written in place
    _close(_np(Xt), ref, dtype)
    Z = tv.zeros_basis(_t(y), 4)
    Zj = jv.zeros_basis(_j(y), 4)
    for k in Z:
        assert tuple(Z[k].shape) == Zj[k].shape and not Z[k].any()
        assert Z[k].dtype == lt.constants.as_torch_dtype(dtype)


def test_basis_reductions(dtype):
    X, y, Y = _inputs(dtype, seed=1)
    _close(tv.innerprod(_t(X), _t(y)).numpy(), jv.innerprod(_j(X), _j(y)), dtype)
    _close(tv.innerprod(_t(X), _t(Y)).numpy(), jv.innerprod(_j(X), _j(Y)), dtype)
    _close(tv.gram(_t(X)).numpy(), jv.gram(_j(X)), dtype)
    _close(tv.innerprod_vpu(_t(X), _t(Y)).numpy(), jv.innerprod_vpu(_j(X), _j(Y)), dtype)


def test_linear_combinations(dtype):
    X, _, _ = _inputs(dtype, seed=2)
    rng = np.random.default_rng(3)
    v = _rand(rng, (K,), dtype)
    B = _rand(rng, (K, 3), dtype)
    C = _rand(rng, (K, 2), dtype)
    _close(_np(tv.linear_combination(_t(X), torch.from_numpy(v))),
           jv.linear_combination(_j(X), jnp.asarray(v)), dtype)
    _close(_np(tv.linear_combination(_t(X), torch.from_numpy(B))),
           jv.linear_combination(_j(X), jnp.asarray(B)), dtype)
    _close(_np(tv.linear_combination_vpu(_t(X), torch.from_numpy(C))),
           jv.linear_combination_vpu(_j(X), jnp.asarray(C)), dtype)


@pytest.mark.parametrize("shape", [(K,), (K, 3)], ids=["vector", "matrix"])
def test_complex_coefficients_on_real_basis(shape):
    """Complex coefficients on a real basis (Ritz-vector reconstruction)."""
    X, _, _ = _inputs(np.float64, seed=4)
    v = _rand(np.random.default_rng(5), shape, np.complex128)
    _close(_np(tv.linear_combination(_t(X), torch.from_numpy(v))),
           jv.linear_combination(_j(X), jnp.asarray(v)), np.complex128)


def test_reductions_over_no_columns(dtype):
    """A view of the filled columns may be empty (the first column of a QR
    or a factorization): the projection is empty and changes nothing."""
    X, y, Y = _inputs(dtype, seed=6)
    empty = tv.lead(_t(X), 0)
    assert tv.innerprod(empty, _t(y)).shape == (0,)
    assert tv.innerprod(empty, _t(Y)).shape == (0, 2)
    coeff = torch.zeros(0, dtype=lt.constants.as_torch_dtype(dtype))
    assert all(not v.any() for v in tv.linear_combination(empty, coeff).values())
    y_orth, proj = lt.double_gram_schmidt_step(_t(y), empty)
    assert proj.shape == (0,)
    _close(_np(y_orth), y, dtype)


def test_more_vector_helpers(dtype):
    """sub, chsgn, get_size, stack/unstack, copy, set_columns_block,
    axpby_basis, scal_basis and zero_basis_like against JAX."""
    X, y, Y = _inputs(dtype, seed=7)
    x = {k: v[0] for k, v in X.items()}
    a, b = dtype(0.3), dtype(-2.0)
    _close(_np(tv.sub(_t(x), _t(y))), jv.sub(_j(x), _j(y)), dtype)
    _close(_np(tv.chsgn(_t(x))), jv.chsgn(_j(x)), dtype)
    assert tv.get_size(_t(x)) == jv.get_size(_j(x)) == 6 * 7 + 9
    cols = tv.unstack(_t(X))
    assert len(cols) == K
    _close(_np(tv.stack(cols)), jv.stack(jv.unstack(_j(X))), dtype)
    Xt = _t(X)
    Xc = tv.copy(Xt)
    tv.set_column(Xc, 0, _t(y))
    _close(_np(Xt), X, dtype)  # the copy owns its storage
    out = tv.set_columns_block(Xt, 1, _t(Y))
    assert out is Xt
    _close(_np(Xt), jv.set_columns_block(_j(X), 1, _j(Y)), dtype)
    _close(_np(tv.axpby_basis(a, _t(X), b, _t(X))), jv.axpby_basis(a, _j(X), b, _j(X)), dtype)
    alpha = _rand(np.random.default_rng(8), (K,), dtype)
    _close(_np(tv.scal_basis(alpha, _t(X))), jv.scal_basis(jnp.asarray(alpha), _j(X)), dtype)
    _close(_np(tv.scal_basis(torch.from_numpy(alpha), _t(X))),
           jv.scal_basis(jnp.asarray(alpha), _j(X)), dtype)
    _close(_np(tv.scal_basis(a, _t(X))), jv.scal_basis(a, _j(X)), dtype)
    Z = tv.zero_basis_like(_t(X))
    assert all(not v.any() and v.shape == X[k].shape for k, v in Z.items())


def test_verify_vector_axioms(dtype):
    template = {"u": torch.zeros(SHAPE, dtype=lt.constants.as_torch_dtype(dtype)),
                "w": [torch.zeros(9, dtype=lt.constants.as_torch_dtype(dtype))]}
    tv.verify_vector_axioms(torch.Generator().manual_seed(0), template, n_trials=5)
    with pytest.raises(AssertionError, match="axiom"):
        tv.verify_vector_axioms(torch.Generator().manual_seed(0), template, n_trials=1, rtol=0.0)


def test_package_pins_full_float32_matmuls():
    """TF32 would cost f32 Krylov reductions about three digits."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_import_leaves_jax_unloaded():
    code = ("import sys, lightkrylov_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('lightkrylov_tpu.') or m == 'lightkrylov_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
