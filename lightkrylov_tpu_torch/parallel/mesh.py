"""Process group, a 1-D mesh handle and row-partitioned vectors.

Counterpart of :mod:`lightkrylov_tpu.parallel.mesh` (reference:
src/Constants.f90:60-100 rank plumbing; src/Utilities/Logger.f90:245-288
``comm_setup``/``comm_close``).  JAX is single-controller: a global array
carries a ``NamedSharding`` and GSPMD inserts the collectives.  Here, as in
torch's idiom and the reference's MPI model, there is one process per
device, and a partitioned vector is a plain tensor (or pytree of tensors)
holding this rank's rows of each leaf.  The vector layer sums its inner
products over the group that :func:`comm_setup` sets
(:func:`..vectors.set_reduction_group`); the sharded operators exchange
their halos over the same group.

Every leaf is cut into equal row blocks, rank ``r`` holding rows
``r*n/P .. (r+1)*n/P - 1`` of a leaf of ``n`` rows, so the global row count
must divide by the group size ``P``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .. import vectors
from ..constants import resolve_device
from ..utils.logger import log_information

__all__ = [
    "Mesh",
    "comm_setup",
    "comm_close",
    "make_mesh",
    "distribute",
    "replicate",
    "shard_rows",
    "gather",
]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process ``group`` (``None`` for one process without
    a group), its ``size``, this process's ``rank`` in it, and the
    ``device`` that holds this rank's shards."""

    group: object
    size: int
    rank: int
    device: torch.device


def _local_device(device) -> torch.device:
    """``device`` with the index of this process's card: ``LOCAL_RANK``
    (set by ``torchrun``) modulo the visible cards, unless it names one."""
    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        device = torch.device("cuda", local % cards)
    return device


def comm_setup(backend: str | None = None, *, init_method: str | None = None,
               store=None, world_size: int | None = None, rank: int | None = None,
               timeout: float | None = None, device=None) -> None:
    """Join the process group and reduce the vector layer over it
    (reference: ``comm_setup``, Logger.f90:245-276, MPI init-if-needed and
    rank capture).

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` (default: the
    package's default device) and ``gloo`` for the CPU; it is the caller's
    choice and is never switched.  ``init_method`` (such as
    ``"file:///tmp/store"`` or ``"tcp://localhost:29500"``) or ``store``,
    ``world_size`` and ``rank`` go to ``torch.distributed.init_process_group``;
    without them it reads ``torchrun``'s environment.  ``timeout`` is in
    seconds.  Started without any of them and outside ``torchrun``, it is a
    single process: nothing is initialised and nothing reduced, as the JAX
    ``comm_setup`` does nothing in single-process mode.  On a CUDA device it
    selects this rank's card (``LOCAL_RANK``)."""
    single = (init_method is None and store is None and world_size is None
              and "WORLD_SIZE" not in os.environ)
    if not single and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method, store=store,
                                world_size=-1 if world_size is None else world_size,
                                rank=-1 if rank is None else rank, **kw)
    if dist.is_initialized():
        vectors.set_reduction_group(dist.group.WORLD)
        dev = _local_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        log_information(f"comm_setup: rank {dist.get_rank()}/{dist.get_world_size()}, "
                        f"backend {dist.get_backend()}, device {dev}", "parallel", "comm_setup")
    else:
        log_information("comm_setup: single process, no process group", "parallel",
                        "comm_setup")


def comm_close() -> None:
    """Leave the process group and stop reducing over it (reference:
    ``comm_close``, Logger.f90:277-288, MPI finalize-if-needed).  A no-op
    when no group was set up."""
    vectors.set_reduction_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()
        log_information("comm_close: process group destroyed", "parallel", "comm_close")


def make_mesh(group=None, device=None) -> Mesh:
    """The 1-D mesh over ``group`` (default: the vector layer's reduction
    group, the whole world after :func:`comm_setup`), with this rank's
    shards on ``device`` (default: the package's default device, on this
    rank's card).  Without a group it is one process of size 1."""
    if group is None:
        group = vectors.reduction_group()
    if group is None:
        return Mesh(None, 1, 0, _local_device(device))
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), _local_device(device))


def shard_rows(mesh: Mesh, n: int) -> slice:
    """The rows of an axis of length ``n`` that this rank holds.  The JAX
    function of this name returns the sharding that partitions rows; the
    port's partition is fixed, so this gives the slice it selects."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over a mesh of {mesh.size}")
    m = n // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def _as_tensor(leaf, device):
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.from_numpy(np.array(leaf)).to(device)


def distribute(x, mesh: Mesh, dim: int = 0):
    """This rank's rows of every leaf of the global pytree ``x`` (tensors or
    arrays), cut along ``dim`` (0 for a vector, 1 for a stacked basis) and
    placed on the mesh's device (reference: none; SURVEY.md §2 item 1)."""

    def leaf(a):
        rows = shard_rows(mesh, a.shape[dim])
        index = (slice(None),) * dim + (rows,)
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        # a copy, never a view into the caller's global tensor
        return a[index].to(mesh.device, copy=True).contiguous()

    return pytree.tree_map(leaf, x)


def replicate(x, mesh: Mesh):
    """Every leaf whole on the mesh's device: the small dense projected
    quantities (Hessenberg matrices, Givens buffers) every rank holds."""
    return pytree.tree_map(lambda a: _as_tensor(a, mesh.device), x)


def gather(x, mesh: Mesh, dim: int = 0):
    """The global pytree on every rank: each leaf's row blocks joined along
    ``dim`` by one ``all_gather`` a leaf.  The JAX package needs no such
    function (its arrays are global); here it serves tests and
    checkpoints, never the solvers."""
    if mesh.group is None:
        return x

    def leaf(a):
        a = a.contiguous()
        parts = [torch.empty_like(a) for _ in range(mesh.size)]
        dist.all_gather(parts, a, group=mesh.group)
        return torch.cat(parts, dim)

    return pytree.tree_map(leaf, x)
