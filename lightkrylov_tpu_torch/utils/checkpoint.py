"""Checkpoint and resume of Krylov factorization state.

Counterpart of :mod:`lightkrylov_tpu.utils.checkpoint`.  The reference can
restart a factorization algorithmically (``kstart``/``kend`` and Krylov-Schur
compression) but never writes its state (SURVEY.md §5); this module writes a
pytree of tensors, arrays and scalars (basis buffers, projected matrix,
counters) to one ``.npz`` and reads it back.

The file layout is the JAX package's: leaf ``i`` is stored under
``f"{i:04d}|{path}"``, where ``path`` joins the leaf's keys with ``/`` as
``jax.tree_util`` prints them (``['X']`` for a dict key, ``[0]`` for a list
or tuple index), and dict keys are visited in sorted order, as JAX flattens
them.  So a solver's state written by either package loads in the other.

The JAX package's Orbax backend (``save_checkpoint_orbax``) is not carried
over: its counterpart, ``torch.distributed.checkpoint`` for sharded state,
belongs with the partitioned operators (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np
import torch

from .timer import host_read

__all__ = ["save_checkpoint", "load_checkpoint"]


def _flatten_with_paths(tree, prefix=()):
    """``[(path, leaf)]`` in JAX's order: dict keys sorted, sequences by
    index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [pair for key, sub in items for pair in _flatten_with_paths(sub, prefix + (key,))]


def _unflatten(template, leaves):
    """``template`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        new = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_numpy(leaf):
    return host_read(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_checkpoint(state, path: str) -> None:
    """Write a pytree of tensors, arrays and scalars to ``path`` (``.npz``;
    numpy appends the suffix when ``path`` lacks it)."""
    arrays = {f"{i:04d}|{key}": _to_numpy(leaf)
              for i, (key, leaf) in enumerate(_flatten_with_paths(state))}
    np.savez(path, **arrays)


def load_checkpoint(state_template, path: str):
    """Read a pytree written by :func:`save_checkpoint` (by this package or
    the JAX package).  ``state_template`` gives the structure; a leaf whose
    template is a tensor comes back as a tensor on that tensor's device, any
    other as a numpy array, each in the dtype it was saved in."""
    with np.load(path) as data:
        ordered = [data[k] for k in sorted(data.files)]
    tmpl = [leaf for _, leaf in _flatten_with_paths(state_template)]
    if len(ordered) != len(tmpl):
        raise ValueError(f"checkpoint has {len(ordered)} leaves, template has {len(tmpl)}")
    leaves = [torch.from_numpy(arr).to(t.device) if isinstance(t, torch.Tensor) else arr
              for t, arr in zip(tmpl, ordered)]
    return _unflatten(state_template, iter(leaves))
