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
