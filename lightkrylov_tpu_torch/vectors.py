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

Row-partitioned vectors
-----------------------
Where the JAX package gave a global array a ``NamedSharding`` and let GSPMD
insert the all-reduce behind each inner product (its ``parallel/mesh.py``),
a partitioned vector here is a plain tensor, or pytree of tensors, that
holds this rank's rows of every leaf (:func:`..parallel.distribute`).  While
a reduction group is set (:func:`set_reduction_group`, which
:func:`..parallel.comm_setup` calls), ``dot``, ``norm``, ``innerprod`` and
``gram`` end with one all-reduce of their local result over it, counted as
``"all_reduces"`` by :func:`..utils.timer.count_collective`; nothing else
in the package reduces over the group, and the small projected quantities
(Hessenberg matrices, coefficients) stay replicated.  Without a group the
vectors are whole and nothing is reduced.
"""

from __future__ import annotations

import math
import operator
from functools import reduce

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .utils.timer import count_collective, timed

__all__ = [
    "set_reduction_group",
    "reduction_group",
    "allreduce_sum",
    "dot",
    "dot_local",
    "norm",
    "scal",
    "axpby",
    "add",
    "sub",
    "chsgn",
    "zero_like",
    "dtype_of",
    "get_size",
    "rand_like",
    "rand_basis",
    "get_column",
    "set_column",
    "set_columns_block",
    "lead",
    "copy",
    "stack",
    "unstack",
    "zeros_basis",
    "zero_basis_like",
    "basis_size",
    "axpby_basis",
    "scal_basis",
    "innerprod",
    "innerprod_local",
    "gram",
    "linear_combination",
    "innerprod_vpu",
    "linear_combination_vpu",
    "verify_vector_axioms",
]


# -- internals ---------------------------------------------------------------

def _leaves(x):
    return pytree.tree_leaves(x)


def _tree_sum(terms):
    return reduce(operator.add, terms)


def _as_matrix(leaf):
    """Flatten a basis leaf (k, *S) to (k, prod(S)); k may be 0."""
    return leaf.reshape(leaf.shape[0], math.prod(leaf.shape[1:]))


def _common(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# -- the reduction group -----------------------------------------------------

_group = None


def set_reduction_group(group):
    """Reduce every inner product over ``group`` (a process group, or
    ``None`` for no reduction) from now on; returns the group it replaces."""
    global _group
    prev, _group = _group, group
    return prev


def reduction_group():
    """The process group the inner products reduce over, or ``None``."""
    return _group


def _shard():
    """``(rank, size)`` of this process in the reduction group; ``(0, 1)``
    without one."""
    if _group is None:
        return 0, 1
    return dist.get_rank(_group), dist.get_world_size(_group)


def allreduce_sum(*parts):
    """Each tensor of ``parts`` summed over the reduction group, in a tuple,
    by ONE counted all-reduce: several parts travel in one buffer, in their
    promoted dtype.  Without a group the parts come back as they are.  The
    collective is a span ``allreduce`` while timing is on."""
    if _group is None:
        return parts
    count_collective("all_reduces")
    if len(parts) == 1:
        buf = parts[0].contiguous()  # the caller's fresh local result
        with timed("allreduce", "parallel", device=True):
            dist.all_reduce(buf, group=_group)
        return (buf,)
    dt = reduce(torch.promote_types, (p.dtype for p in parts))
    buf = torch.cat([p.reshape(-1).to(dt) for p in parts])
    with timed("allreduce", "parallel", device=True):
        dist.all_reduce(buf, group=_group)
    out, start = [], 0
    for p in parts:
        out.append(buf[start:start + p.numel()].reshape(p.shape).to(p.dtype))
        start += p.numel()
    return tuple(out)


# -- vector algebra ----------------------------------------------------------

def dot_local(x, y):
    """This rank's share of :func:`dot`: its rows only, no reduction."""
    return _tree_sum([torch.vdot(*_common(xl.reshape(-1), yl.reshape(-1)))
                      for xl, yl in zip(_leaves(x), _leaves(y))])


def dot(x, y):
    """Inner product ``x^H y`` summed over every leaf (``torch.vdot``
    conjugates its first argument) and over the reduction group."""
    return allreduce_sum(dot_local(x, y))[0]


def norm(x):
    """Euclidean norm over every leaf and the reduction group, as a 0-d
    real tensor."""
    leaves = _leaves(x)
    if _group is None and len(leaves) == 1:
        return torch.linalg.vector_norm(leaves[0])
    squares = _tree_sum([torch.linalg.vector_norm(l) ** 2 for l in leaves])
    return torch.sqrt(allreduce_sum(squares)[0])


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


def sub(x, y):
    return pytree.tree_map(torch.sub, x, y)


def chsgn(x):
    return pytree.tree_map(torch.neg, x)


def zero_like(x):
    return pytree.tree_map(torch.zeros_like, x)


def get_size(x) -> int:
    """Total number of scalar entries of the global vector (reference:
    deferred ``get_size``): this rank's entries times the group size, since
    :func:`..parallel.distribute` cuts every leaf into equal row blocks."""
    return sum(leaf.numel() for leaf in _leaves(x)) * _shard()[1]


def dtype_of(x) -> torch.dtype:
    """Dtype of the (first leaf of the) vector."""
    return _leaves(x)[0].dtype


def rand_like(generator, x, ifnorm: bool = False):
    """Standard-normal random vector with the structure and dtype of ``x``,
    drawn from ``generator`` (reference: deferred ``rand``, normalised with
    ``ifnorm``).  As in the JAX package, a complex leaf has standard-normal
    real and imaginary parts.  The numbers are drawn on the generator's
    device and moved to each leaf's.

    Under a reduction group each rank draws the global leaf, whose rows
    are the group size times its own, and keeps its own rows: with the
    same generator state on every rank the partitioned vector is the
    serial draw."""
    rank, size = _shard()

    def draw(shape, dtype):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)

    def leaf_fn(leaf):
        shape = leaf.shape
        if size > 1 and leaf.ndim:
            shape = (shape[0] * size,) + tuple(shape[1:])
        if leaf.is_complex():
            rdt = leaf.real.dtype
            out = torch.complex(draw(shape, rdt), draw(shape, rdt))
        else:
            out = draw(shape, leaf.dtype)
        if shape != leaf.shape:
            n = leaf.shape[0]
            out = out[rank * n:(rank + 1) * n].clone()
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


def set_columns_block(X, i, B):
    """Copy the stacked block ``B`` (leading axis p) into columns
    ``i .. i+p-1`` of ``X`` in place; returns ``X``."""
    pytree.tree_map(lambda Xl, Bl: Xl[i:i + Bl.shape[0]].copy_(Bl), X, B)
    return X


def copy(X):
    """A copy that owns its storage.  The JAX package's ``copy`` is the
    identity, since its arrays are immutable; here columns are written in
    place, so the copy is a clone."""
    return pytree.tree_map(torch.clone, X)


def stack(vectors):
    """Stack a list of vectors into a basis with leading axis k."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves), *vectors)


def unstack(X):
    """Inverse of :func:`stack`: the list of column views."""
    return [get_column(X, i) for i in range(basis_size(X))]


def zeros_basis(x_template, k: int, device=None):
    """A k-column zero basis shaped like ``x_template``, on ``device``
    (default: the template's device)
    (reference: ``zero_basis``, AbstractVectors.fypp:697-708)."""
    return pytree.tree_map(
        lambda l: torch.zeros((k,) + tuple(l.shape), dtype=l.dtype,
                              device=l.device if device is None else device),
        x_template)


def zero_basis_like(X):
    return pytree.tree_map(torch.zeros_like, X)


def rand_basis(generator, X, ifnorm: bool = False):
    """Random basis with the structure of ``X``, one :func:`rand_like`
    column after another (reference: ``rand_basis``)."""
    return stack([rand_like(generator, get_column(X, 0), ifnorm) for _ in range(basis_size(X))])


def axpby_basis(alpha, X, beta, Y):
    """Column by column ``alpha*X + beta*Y``
    (reference: ``axpby_basis``, AbstractVectors.fypp:709-720)."""
    return axpby(alpha, X, beta, Y)


def scal_basis(alpha, X):
    """Scale each column; ``alpha`` is a scalar or has shape (k,)."""
    alpha = _scalar(alpha)

    def leaf_fn(Xl):
        if not isinstance(alpha, (torch.Tensor, np.ndarray)):
            return alpha * Xl
        a = torch.as_tensor(alpha, device=Xl.device).to(Xl.dtype)
        return a.reshape(a.shape + (1,) * (Xl.ndim - a.ndim)) * Xl

    return pytree.tree_map(leaf_fn, X)


def innerprod(X, y):
    """``X^H y -> (k,)`` for a vector ``y``, ``X^H Y -> (k, m)`` for a
    stacked block ``Y`` (reference: AbstractVectors.fypp:659-695).

    One matrix product per leaf and one all-reduce over the reduction
    group.  The conjugate transpose is taken as a view (``.mH``), so no
    conjugated copy of the basis is made."""
    return allreduce_sum(innerprod_local(X, y))[0]


def innerprod_local(X, y):
    """This rank's share of :func:`innerprod`: its rows only, no reduction."""
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


# -- property-based axiom checking -------------------------------------------

def verify_vector_axioms(generator, x_template, n_trials: int = 100, rtol=None):
    """Check the 8 vector-space axioms on random data drawn from
    ``generator`` (reference: ``verify_vector_axioms``,
    AbstractVectors.fypp:733-927): commutativity and associativity of
    addition, additive identity and inverse, both distributivities,
    associativity of scalar multiplication and its identity.  Raises
    ``AssertionError`` on a violation."""
    from . import constants

    dt = dtype_of(x_template)
    tol = rtol if rtol is not None else constants.rtol(dt)

    def rand_scalar():
        r = torch.randn(2, generator=generator, dtype=torch.float64)
        return complex(r[0], r[1]) if dt.is_complex else float(r[0])

    for _ in range(n_trials):
        x, y, z = (rand_like(generator, x_template) for _ in range(3))
        a, b = rand_scalar(), rand_scalar()
        scale = float(norm(x)) + 1.0

        def check(u, v, label):
            err = float(norm(sub(u, v))) / scale
            if not err < tol:
                raise AssertionError(f"vector axiom '{label}' violated: err={err:.3e}")

        check(add(x, y), add(y, x), "commutativity")
        check(add(add(x, y), z), add(x, add(y, z)), "associativity")
        check(add(x, zero_like(x)), x, "additive identity")
        check(add(x, chsgn(x)), zero_like(x), "additive inverse")
        check(scal(a, add(x, y)), add(scal(a, x), scal(a, y)), "distributivity over vectors")
        check(scal(a + b, x), add(scal(a, x), scal(b, x)), "distributivity over scalars")
        check(scal(a * b, x), scal(a, scal(b, x)), "scalar associativity")
        check(scal(1, x), x, "multiplicative identity")
