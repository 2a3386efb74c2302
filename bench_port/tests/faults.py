"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  Each function patches the program in the process that
calls it; the harness calls it by name in every rank (``patch=``)."""

import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.parallel import stencil as sharded

_saved = []


def _set(owner, name, value):
    _saved.append((owner, name, getattr(owner, name)))
    setattr(owner, name, value)


def restore():
    """Undo every patch made in this process."""
    while _saved:
        owner, name, value = _saved.pop()
        setattr(owner, name, value)


def _wrap(name, after):
    """Wrap the program's solver ``lt.<name>``, which the loops call."""
    original = getattr(lt, name)

    def wrapped(*args, **kwargs):
        return after(original(*args, **kwargs), *args, **kwargs)
    _set(lt, name, wrapped)


def gmres_state_unchanged():
    """A cycle that returns its start ``x0 = 0``."""
    _wrap("gmres", lambda out, *a, **k: (torch.zeros_like(out[0]),) + tuple(out[1:]))


def gmres_answer_altered():
    """A cycle whose iterate is off by one part in a thousand."""
    _wrap("gmres", lambda out, *a, **k: (out[0] * 1.001,) + tuple(out[1:]))


def cg_state_unchanged():
    _wrap("cg", lambda out, *a, **k: (torch.zeros_like(out[0]),) + tuple(out[1:]))


def cg_answer_altered():
    _wrap("cg", lambda out, *a, **k: (out[0] * 1.001,) + tuple(out[1:]))


def halo_left_out():
    """The sharded operator's exchange between ranks left out: each rank
    sees zeros beyond its own rows."""
    def halo_rows(u, mesh):
        zero = torch.zeros_like(u[0])
        return zero, zero
    _set(sharded, "halo_rows", halo_rows)


def allreduce_left_out():
    """The vector layer's reductions left out: each rank sums its own rows
    only."""
    _set(lt.vectors, "allreduce_sum", lambda *parts: parts)
