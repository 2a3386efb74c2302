"""The cells' inputs and the program's operators, built from a
configuration's numbers: what every loop over a Poisson grid shares.

Inputs are made on the run's device from the run's seed, the same on every
rank, so that the reference can make them again; a rank keeps its own
rows."""

from __future__ import annotations

import torch


def dtype(config) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


def rows(run, ny: int) -> slice:
    """The rows of a grid of ``ny`` rows that this rank holds."""
    if ny % run.world:
        raise ValueError(f"{ny} rows do not divide over {run.world} ranks")
    m = ny // run.world
    return slice(run.rank * m, (run.rank + 1) * m)


def global_rhs(run, j: int) -> torch.Tensor:
    """Right-hand side ``j`` of the cell: the whole ``(ny, nx)`` grid,
    standard normal, from the run's seed."""
    c = run.cell.config
    return torch.randn((c["ny"], c["nx"]), generator=run.generator(1, j), device=run.device,
                       dtype=dtype(c))


def rhs_pool(run, count: int):
    """This rank's rows of right-hand sides ``0 .. count-1``."""
    sl = rows(run, run.cell.config["ny"])
    return [global_rhs(run, j)[sl].clone() for j in range(count)]


def poisson_operator(run):
    """The program's operator of the configuration: the stencil kernel's
    ``CudaPoisson2D`` on one rank, ``ShardedPoisson2D`` over the ranks."""
    lt, c = run.lt, run.cell.config
    if run.world > 1:
        op = lt.ShardedPoisson2D(c["nx"], c["ny"], mesh=lt.make_mesh(), dtype=dtype(c),
                                 kernel="cuda" if run.cuda else "plain")
    else:
        op = lt.CudaPoisson2D(c["nx"], c["ny"], dtype=dtype(c), device=run.device)
    op.label = "bench_operator"  # the counter key of its applications
    return op


def gather_rows(run, local: torch.Tensor) -> torch.Tensor | None:
    """The whole grid from every rank's rows of it, on rank 0 (``None`` on
    the others); ``local`` itself on one rank."""
    if run.world == 1:
        return local
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(run.world)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts) if run.rank == 0 else None


def free_program_state(run, keep=()) -> None:
    """Drop everything the loop holds but ``keep`` and return the cached
    device memory, so that the reference fits beside the answers."""
    for key in [k for k in run.state if k not in keep]:
        del run.state[key]
    if run.cuda:
        torch.cuda.empty_cache()
