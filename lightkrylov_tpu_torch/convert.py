"""Carry state across from the JAX package.

``to_torch`` turns arrays (numpy, or anything with ``__array__``, such as a
JAX array) into tensors of the same dtype; ``port_operator`` maps a
``lightkrylov_tpu`` operator to its counterpart here; ``port_options`` maps
an options record by field name.

Nothing here imports jax or ``lightkrylov_tpu``: an operator is read through
its class name, its ``_static`` fields and its ``_children`` arrays, which
the JAX operators declare for pytree registration (``linops.py:56-80``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .linops import DenseOperator, DiagonalOperator, IdentityOperator
from .models.poisson import BlockJacobiPoisson, Poisson2D
from .ops.stencil import CudaPoisson2D
from .utils.options import CGOptions, GMRESOptions

__all__ = ["to_torch", "port_operator", "port_options"]


def to_torch(tree, device=None):
    """Every array leaf of ``tree`` as a tensor on ``device``, dtype kept.
    Leaves without ``__array__`` (Python scalars, tensors) pass through."""

    def leaf(a):
        if isinstance(a, torch.Tensor) or not hasattr(a, "__array__"):
            return a
        t = torch.from_numpy(np.array(a))
        return t if device is None else t.to(device)

    return pytree.tree_map(leaf, tree)


def _poisson(static, children, device):
    return Poisson2D(static["nx"], static["ny"], dtype=static["dtype_"],
                     device=device)


def _pallas_poisson(static, children, device):
    return CudaPoisson2D(static["nx"], static["ny"], dtype=static["dtype_"],
                         tile=static["tile"], tile_x=static["tile_x"],
                         device=device)


_PORTS = {
    "Poisson2D": _poisson,
    "PallasPoisson2D": _pallas_poisson,
    "BlockJacobiPoisson": lambda st, ch, dev: BlockJacobiPoisson.from_block_inverse(ch["Binv"]),
    "DenseOperator": lambda st, ch, dev: DenseOperator(ch["data"], is_hermitian=st["is_hermitian"]),
    "DiagonalOperator": lambda st, ch, dev: DiagonalOperator(ch["d"]),
    "IdentityOperator": lambda st, ch, dev: IdentityOperator(),
}


def port_operator(op, device=None):
    """The counterpart of the JAX operator ``op``, with its arrays on
    ``device``: ``Poisson2D`` -> ``Poisson2D``, ``PallasPoisson2D`` ->
    ``CudaPoisson2D``, ``BlockJacobiPoisson`` (same ``Binv``), and the dense,
    diagonal and identity operators."""
    name = type(op).__name__
    if name not in _PORTS:
        raise TypeError(f"no counterpart for operator type {name!r}")
    static = {n: getattr(op, n) for n in type(op)._static}
    children = {n: to_torch(getattr(op, n), device) for n in type(op)._children}
    return _PORTS[name](static, children, device)


def port_options(opts):
    """The options record of the same name, field by field."""
    cls = {"GMRESOptions": GMRESOptions, "CGOptions": CGOptions}[type(opts).__name__]
    return cls(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(cls)})
