"""Carry state across from the JAX package.

``to_torch`` turns arrays (numpy, or anything with ``__array__``, such as a
JAX array) into tensors of the same dtype; ``port_operator`` maps a
``lightkrylov_tpu`` operator to its counterpart here; ``port_options`` maps
an options record by field name.

Nothing here imports jax or ``lightkrylov_tpu``: an operator is read through
its class name, its ``_static`` fields and its ``_children``, which the JAX
operators declare for pytree registration (``linops.py:56-80``).  A child
is an array or, as in ``GLPropagator``, another operator, which is ported in
turn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .constants import resolve_device
from .linops import DenseOperator, DiagonalOperator, IdentityOperator
from .models.convdiff import ConvectionDiffusion2D
from .models.ginzburg_landau import GinzburgLandau, GinzburgLandauReal, GLPropagator
from .models.poisson import BlockJacobiPoisson, Poisson2D
from .models.toeplitz import TridiagToeplitz
from .ops.spmv import BellMatrix, BellOperator
from .ops.stencil import CudaPoisson2D
from .solvers.expm import ExponentialPropagator
from .utils.options import (CGOptions, EigsOptions, GMRESOptions, KexpmOptions,
                            NewtonOptions, SVDSOptions)

__all__ = ["to_torch", "port_operator", "port_options"]


def to_torch(tree, device=None):
    """Every array leaf of ``tree`` as a tensor on ``device`` (default: the
    package's default device, :func:`..constants.default_device`), dtype
    kept.  Leaves without ``__array__`` (Python scalars, tensors) pass
    through."""
    device = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor) or not hasattr(a, "__array__"):
            return a
        return torch.from_numpy(np.array(a)).to(device)

    return pytree.tree_map(leaf, tree)


def _poisson(static, children, device):
    return Poisson2D(static["nx"], static["ny"], dtype=static["dtype_"],
                     device=device)


def _pallas_poisson(static, children, device):
    return CudaPoisson2D(static["nx"], static["ny"], dtype=static["dtype_"],
                         tile=static["tile"], tile_x=static["tile_x"],
                         device=device)


def _bell(static, children, device):
    bell = BellMatrix(children["data"], children["cols"], static["shape"], static["nnz"])
    return BellOperator(bell, is_hermitian=static["is_hermitian"],
                        interpret=static["interpret"], rows_per_step=static["rows_per_step"])


def _convdiff(static, children, device):
    return ConvectionDiffusion2D(static["nx"], static["ny"], eps=static["eps"],
                                 cx=static["cx"], cy=static["cy"], dtype=static["dtype_"],
                                 device=device)


def _toeplitz(static, children, device):
    a, b, c = children["a"], children["b"], children["c"]
    return TridiagToeplitz(static["n"], a, b, c, dtype=a.dtype, device=device)


def _gl(cls):
    def port(static, children, device):
        return cls(static["nx"], static["L"], dtype=static["dtype_"], device=device)
    return port


_PORTS = {
    "Poisson2D": _poisson,
    "PallasPoisson2D": _pallas_poisson,
    "BlockJacobiPoisson": lambda st, ch, dev: BlockJacobiPoisson.from_block_inverse(ch["Binv"]),
    "DenseOperator": lambda st, ch, dev: DenseOperator(ch["data"], is_hermitian=st["is_hermitian"],
                                                       device=dev),
    "DiagonalOperator": lambda st, ch, dev: DiagonalOperator(ch["d"]),
    "IdentityOperator": lambda st, ch, dev: IdentityOperator(),
    "BellOperator": _bell,
    "ConvectionDiffusion2D": _convdiff,
    "TridiagToeplitz": _toeplitz,
    "GinzburgLandau": _gl(GinzburgLandau),
    "GinzburgLandauReal": _gl(GinzburgLandauReal),
    "GLPropagator": lambda st, ch, dev: GLPropagator(ch["A"], tau=st["tau"],
                                                     n_steps=st["n_steps"]),
    "ExponentialPropagator": lambda st, ch, dev: ExponentialPropagator(
        ch["A"], ch["tau"], kdim=st["kdim"], tol=st["tol"]),
}


def _is_operator(child):
    """A JAX operator: it declares its pytree fields on its class."""
    return hasattr(type(child), "_children") and hasattr(type(child), "_static")


def port_operator(op, device=None):
    """The counterpart of the JAX operator ``op``, with its arrays on
    ``device`` (default: the package's default device):
    ``Poisson2D`` -> ``Poisson2D``, ``PallasPoisson2D`` ->
    ``CudaPoisson2D``, ``BlockJacobiPoisson`` (same ``Binv``),
    ``BellOperator`` (same blocks), ``ConvectionDiffusion2D``,
    ``TridiagToeplitz``, ``GinzburgLandau``, ``GinzburgLandauReal``,
    ``GLPropagator`` and ``ExponentialPropagator`` (their operator children
    ported in turn), and the dense, diagonal and identity operators."""
    name = type(op).__name__
    if name not in _PORTS:
        raise TypeError(f"no counterpart for operator type {name!r}")
    device = resolve_device(device)
    static = {n: getattr(op, n) for n in type(op)._static}
    children = {}
    for n in type(op)._children:
        child = getattr(op, n)
        children[n] = port_operator(child, device) if _is_operator(child) else to_torch(child, device)
    return _PORTS[name](static, children, device)


def port_options(opts):
    """The options record of the same name, field by field."""
    cls = {c.__name__: c for c in (GMRESOptions, CGOptions, EigsOptions, SVDSOptions,
                                   KexpmOptions, NewtonOptions)}[type(opts).__name__]
    return cls(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(cls)})
