"""Pytree vectors and stacked Krylov bases on torch tensors.

Counterpart of :mod:`lightkrylov_tpu.vectors` (reference:
src/AbstractTypes/AbstractVectors.fypp).  A *vector* is a tensor or a pytree
of tensors (``torch.utils._pytree``: dicts, lists, tuples); a *basis* is the
same pytree with one extra leading axis of length k.  Every basis reduction
is one matrix product on the flattened ``(k, prod(S))`` leaf.

Conventions
-----------
* ``dot(x, y) = x^H y``: the first argument is conjugated (reference:
  AbstractVectors.fypp:659-695).
* Unfilled Krylov-buffer columns stay exactly zero, so a projection against
  the whole buffer equals one against the filled columns.  ``zeros_basis``
  allocates with ``torch.zeros`` for that reason.
* Columns are written in place: ``set_column(X, i, v)`` copies ``v`` into
  ``X[i]`` and returns ``X``, where JAX's ``.at[i].set`` built a new array.
  ``get_column`` returns a view, so read a column before overwriting it.
* Random vectors come from an explicit ``torch.Generator`` where the JAX
  package took a PRNG key; the two give different numbers from one seed.
"""

from __future__ import annotations

import operator
from functools import reduce

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "dot",
    "norm",
    "scal",
    "axpby",
    "add",
    "zero_like",
    "dtype_of",
    "rand_like",
    "rand_basis",
    "get_column",
    "set_column",
    "lead",
    "zeros_basis",
    "basis_size",
    "innerprod",
    "gram",
    "linear_combination",
    "innerprod_vpu",
    "linear_combination_vpu",
]


# -- internals ---------------------------------------------------------------

def _leaves(x):
    return pytree.tree_leaves(x)


def _tree_sum(terms):
    return reduce(operator.add, terms)


def _as_matrix(leaf):
    """Flatten a basis leaf (k, *S) to (k, prod(S))."""
    return leaf.reshape(leaf.shape[0], -1)


def _common(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# -- vector algebra ----------------------------------------------------------

def dot(x, y):
    """Inner product ``x^H y`` summed over every leaf (``torch.vdot``
    conjugates its first argument)."""
    return _tree_sum([torch.vdot(*_common(xl.reshape(-1), yl.reshape(-1)))
                      for xl, yl in zip(_leaves(x), _leaves(y))])


def norm(x):
    """Euclidean norm over every leaf, as a 0-d real tensor."""
    leaves = _leaves(x)
    if len(leaves) == 1:
        return torch.linalg.vector_norm(leaves[0])
    return torch.sqrt(_tree_sum([torch.linalg.vector_norm(l) ** 2 for l in leaves]))


def _scalar(a):
    # a numpy scalar times a tensor loses its imaginary part: use the
    # Python number
    return a.item() if isinstance(a, np.generic) else a


def scal(alpha, x):
    """``alpha * x``."""
    alpha = _scalar(alpha)
    return pytree.tree_map(lambda xl: alpha * xl, x)


def axpby(alpha, x, beta, y):
    """``alpha*x + beta*y``."""
    alpha, beta = _scalar(alpha), _scalar(beta)
    return pytree.tree_map(lambda xl, yl: alpha * xl + beta * yl, x, y)


def add(x, y):
    return pytree.tree_map(torch.add, x, y)


def zero_like(x):
    return pytree.tree_map(torch.zeros_like, x)


def dtype_of(x) -> torch.dtype:
    """Dtype of the (first leaf of the) vector."""
    return _leaves(x)[0].dtype


def rand_like(generator, x, ifnorm: bool = False):
    """Standard-normal random vector with the structure and dtype of ``x``,
    drawn from ``generator`` (reference: deferred ``rand``, normalised with
    ``ifnorm``).  As in the JAX package, a complex leaf has standard-normal
    real and imaginary parts.  The numbers are drawn on the generator's
    device and moved to each leaf's."""

    def draw(shape, dtype):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)

    def leaf_fn(leaf):
        if leaf.is_complex():
            rdt = leaf.real.dtype
            out = torch.complex(draw(leaf.shape, rdt), draw(leaf.shape, rdt))
        else:
            out = draw(leaf.shape, leaf.dtype)
        return out.to(leaf.device)

    out = pytree.tree_map(leaf_fn, x)
    if ifnorm:
        out = scal(1.0 / norm(out), out)
    return out


# -- basis (stacked leading axis) algebra ------------------------------------

def basis_size(X) -> int:
    """Number of columns k of a stacked basis."""
    return _leaves(X)[0].shape[0]


def get_column(X, i):
    """Column ``i`` of a stacked basis, as a view."""
    return pytree.tree_map(lambda l: l[i], X)


def lead(X, k: int):
    """View of the first ``k`` columns of a stacked basis (the JAX package
    sliced under ``jit`` for its TPU runtime; here a view costs nothing)."""
    return pytree.tree_map(lambda l: l[:k], X)


def set_column(X, i, v):
    """Copy ``v`` into column ``i`` of ``X`` in place; returns ``X``."""
    pytree.tree_map(lambda Xl, vl: Xl[i].copy_(vl), X, v)
    return X


def zeros_basis(x_template, k: int, device=None):
    """A k-column zero basis shaped like ``x_template``, on ``device``
    (default: the template's device)
    (reference: ``zero_basis``, AbstractVectors.fypp:697-708)."""
    return pytree.tree_map(
        lambda l: torch.zeros((k,) + tuple(l.shape), dtype=l.dtype,
                              device=l.device if device is None else device),
        x_template)


def rand_basis(generator, X, ifnorm: bool = False):
    """Random basis with the structure of ``X``, one :func:`rand_like`
    column after another (reference: ``rand_basis``)."""
    cols = [rand_like(generator, get_column(X, 0), ifnorm) for _ in range(basis_size(X))]
    return pytree.tree_map(lambda *leaves: torch.stack(leaves), *cols)


def innerprod(X, y):
    """``X^H y -> (k,)`` for a vector ``y``, ``X^H Y -> (k, m)`` for a
    stacked block ``Y`` (reference: AbstractVectors.fypp:659-695).

    One matrix product per leaf.  The conjugate transpose is taken as a
    view (``.mH``), so no conjugated copy of the basis is made."""
    terms = []
    for Xl, yl in zip(_leaves(X), _leaves(y)):
        Xl, yl = _common(Xl, yl)
        Xm = _as_matrix(Xl)
        if yl.ndim == Xl.ndim - 1:
            terms.append(yl.reshape(-1) @ Xm.mH)             # (k,)
        else:
            terms.append((_as_matrix(yl) @ Xm.mH).T)          # (k, m)
    return _tree_sum(terms)


def gram(X):
    """Gram matrix ``X^H X`` (reference: AbstractVectors.fypp:645-657)."""
    return innerprod(X, X)


def linear_combination(X, v):
    """``X v`` for coefficients ``v`` of shape (k,) -> a vector, or (k, m)
    -> a basis with leading axis m (reference: AbstractVectors.fypp:571-643).

    Complex coefficients on a real basis contract their real and imaginary
    parts separately, so the basis is never copied to a complex dtype."""

    def contract(coeff, mat):
        return coeff @ mat if coeff.ndim == 1 else coeff.T @ mat

    def leaf_fn(Xl):
        mat = _as_matrix(Xl)
        if v.is_complex() and not Xl.is_complex():
            flat = torch.complex(contract(v.real.to(Xl.dtype), mat),
                                 contract(v.imag.to(Xl.dtype), mat))
        else:
            flat = contract(*_common(v, mat))
        shape = Xl.shape[1:] if v.ndim == 1 else (v.shape[1],) + Xl.shape[1:]
        return flat.reshape(shape)

    return pytree.tree_map(leaf_fn, X)


def linear_combination_vpu(X, C):
    """``X C`` for a (k, p) coefficient matrix with few columns (p ~ 2),
    returned as a basis with leading axis p.

    The JAX package wrote this as a broadcast-multiply-reduce so that XLA
    fuses it into one pass (``vectors.py:424-445``).  Eager torch would
    materialise the ``(k, p, *S)`` product, so here it is the same matrix
    product as :func:`linear_combination`; the name is kept for the callers.
    """
    return linear_combination(X, C)


def innerprod_vpu(X, Y):
    """``X^H Y`` for a stacked block ``Y`` with few columns, shape (k, p).

    As with :func:`linear_combination_vpu`, the fused broadcast form of the
    JAX package (``vectors.py:448-463``) becomes one matrix product here."""
    return innerprod(X, Y)
