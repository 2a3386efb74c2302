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

On row-partitioned state (:mod:`..parallel`) the file holds the global
arrays, as the JAX package's does: ``row_dims`` names the top-level keys
whose leaves are cut along an axis (1 for a stacked basis); writing gathers
them, the IO rank writes and every rank waits for it; reading keeps this
rank's rows.  So a partitioned run resumes from a serial run's file, of
either package, and the other way round.

:func:`save_checkpoint_dcp`/:func:`load_checkpoint_dcp` are the counterparts
of the JAX package's Orbax backend (``save_checkpoint_orbax``/
``load_checkpoint_orbax``, its ``checkpoint.py:67-80``) on
``torch.distributed.checkpoint`` (DCP): a checkpoint is a directory, each
rank writes only its own rows of the partitioned leaves, nothing is
gathered, and loading reshards onto the current group size.  The solvers'
``checkpoint_path`` and ``resume_from`` select it with a path that ends
with a separator, and nothing else (:func:`is_dcp_path`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import constants, vectors
from .timer import host_read

__all__ = ["save_checkpoint", "load_checkpoint", "save_checkpoint_dcp", "load_checkpoint_dcp",
           "is_dcp_path"]


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


def _partitioned_mesh(row_dims):
    """The mesh of the reduction group when ``row_dims`` asks for
    partitioned leaves and a group is set, else ``None``."""
    from ..parallel.mesh import make_mesh

    if not row_dims or vectors.reduction_group() is None:
        return None
    return make_mesh(device="cpu")


def _leaf_dims(state, row_dims):
    """For each leaf of ``state``, in order, the axis it is cut along, or
    ``None`` for a whole leaf."""
    if not row_dims or not isinstance(state, dict):
        return [None] * len(_flatten_with_paths(state))
    return [row_dims.get(k) for k in sorted(state) for _ in _flatten_with_paths(state[k])]


def save_checkpoint(state, path: str, row_dims: dict | None = None) -> None:
    """Write a pytree of tensors, arrays and scalars to ``path`` (``.npz``;
    numpy appends the suffix when ``path`` lacks it).  Only the IO rank
    writes.  Under a reduction group the leaves under the keys of
    ``row_dims`` are this rank's rows along the axis it gives; they are
    gathered first, and every rank waits until the file is written."""
    from ..parallel.mesh import gather

    mesh = _partitioned_mesh(row_dims)
    pairs = _flatten_with_paths(state)
    if mesh is not None:
        pairs = [(key, gather(leaf, mesh, dim) if dim is not None else leaf)
                 for (key, leaf), dim in zip(pairs, _leaf_dims(state, row_dims))]
    if constants.io_rank():
        np.savez(path, **{f"{i:04d}|{key}": _to_numpy(leaf)
                          for i, (key, leaf) in enumerate(pairs)})
    if mesh is not None:
        dist.barrier(mesh.group)


def load_checkpoint(state_template, path: str, row_dims: dict | None = None):
    """Read a pytree written by :func:`save_checkpoint` (by this package or
    the JAX package).  ``state_template`` gives the structure; a leaf whose
    template is a tensor comes back as a tensor on that tensor's device, any
    other as a numpy array, each in the dtype it was saved in.  Under a
    reduction group the leaves under the keys of ``row_dims`` keep this
    rank's rows of the stored global array along the axis it gives."""
    from ..parallel.mesh import shard_rows

    mesh = _partitioned_mesh(row_dims)
    with np.load(path) as data:
        ordered = [data[k] for k in sorted(data.files)]
    tmpl = [leaf for _, leaf in _flatten_with_paths(state_template)]
    if len(ordered) != len(tmpl):
        raise ValueError(f"checkpoint has {len(ordered)} leaves, template has {len(tmpl)}")
    if mesh is not None:
        ordered = [arr if dim is None else np.ascontiguousarray(
                       arr[(slice(None),) * dim + (shard_rows(mesh, arr.shape[dim]),)])
                   for arr, dim in zip(ordered, _leaf_dims(state_template, row_dims))]
    leaves = [torch.from_numpy(arr).to(t.device) if isinstance(t, torch.Tensor) else arr
              for t, arr in zip(tmpl, ordered)]
    return _unflatten(state_template, iter(leaves))


# -- torch.distributed.checkpoint ------------------------------------------------


def is_dcp_path(path) -> bool:
    """Which backend a solver's ``checkpoint_path``/``resume_from`` selects:
    DCP exactly when ``path`` ends with a separator (``"ckpt/"``), else one
    ``.npz`` file.  A path without the separator that names an existing
    directory is refused, so the spelling alone decides."""
    path = os.fspath(path)
    if path.endswith(("/", os.sep)):
        return True
    if os.path.isdir(path):
        raise ValueError(f"checkpoint path {path!r} is a directory: a torch.distributed."
                         f"checkpoint path ends with a separator ({path + os.sep!r}), a "
                         ".npz path names a file")
    return False


def _dcp_entries(state, row_dims, mesh):
    """``{key: tensor}`` for DCP, keyed as the ``.npz`` file is: a leaf
    under a key of ``row_dims`` becomes a DTensor, this rank's rows of the
    global leaf, ``Shard(dim)`` over the mesh's group; any other leaf a
    replicated tensor (numpy values become CPU tensors)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    dims = _leaf_dims(state, row_dims)
    dmesh = {}
    out = {}
    for i, ((key, leaf), dim) in enumerate(zip(_flatten_with_paths(state), dims)):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        if dim is not None and mesh is not None:
            kind = t.device.type
            if kind not in dmesh:
                dmesh[kind] = DeviceMesh.from_group(mesh.group, kind)
            shape = list(t.shape)
            shape[dim] *= mesh.size
            stride = torch.empty(shape, device="meta").stride()
            t = DTensor.from_local(t.contiguous(), dmesh[kind], [Shard(dim)], run_check=False,
                                   shape=torch.Size(shape), stride=stride)
        out[f"{i:04d}|{key}"] = t
    return out


def save_checkpoint_dcp(state, path: str, row_dims: dict | None = None) -> None:
    """Write a pytree of tensors, arrays and scalars to the directory
    ``path`` with ``torch.distributed.checkpoint``; the counterpart of the
    JAX package's ``save_checkpoint_orbax``.  Every rank of the reduction
    group takes part.  The leaves under the keys of ``row_dims`` are this
    rank's rows along the axis it gives, and each rank writes only those;
    the other leaves are replicated and written once.  Nothing is gathered.
    Without a group it writes from this one process."""
    import torch.distributed.checkpoint as dcp

    mesh = _partitioned_mesh(row_dims)
    group = vectors.reduction_group()
    dcp.save(_dcp_entries(state, row_dims, mesh), checkpoint_id=os.fspath(path),
             process_group=group, no_dist=group is None)


def load_checkpoint_dcp(state_template, path: str, row_dims: dict | None = None):
    """Read a pytree written by :func:`save_checkpoint_dcp`, at this or any
    other group size whose row blocks divide the stored rows; the
    counterpart of the JAX package's ``load_checkpoint_orbax``.
    ``state_template`` gives the structure and, for the leaves under the
    keys of ``row_dims``, this rank's shapes: each rank reads only its own
    rows.  A leaf whose template is a tensor comes back as a tensor of the
    template's dtype on its device, any other as a numpy array, as
    :func:`load_checkpoint` returns them."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    mesh = _partitioned_mesh(row_dims)
    group = vectors.reduction_group()
    tmpl = [leaf for _, leaf in _flatten_with_paths(state_template)]
    # fresh buffers shaped like the template, which DCP fills in place
    fresh = [torch.empty_like(t) if isinstance(t, torch.Tensor)
             else torch.from_numpy(np.array(t)) for t in tmpl]
    entries = _dcp_entries(_unflatten(state_template, iter(fresh)), row_dims, mesh)
    dcp.load(entries, checkpoint_id=os.fspath(path), process_group=group, no_dist=group is None)
    leaves = []
    for t, got in zip(tmpl, entries.values()):
        got = got.to_local() if isinstance(got, DTensor) else got
        leaves.append(got if isinstance(t, torch.Tensor) else got.numpy())
    return _unflatten(state_template, iter(leaves))
