"""Distribution layer on ``torch.distributed``: the process group, a 1-D
mesh handle, row-partitioned vectors, and the halo-exchange stencil and
Block-ELL operators (counterpart of :mod:`lightkrylov_tpu.parallel`; the
framework-owned replacement for the reference's user-delegated MPI
distribution, SURVEY.md §2 parallelism inventory)."""

from .mesh import (
    Mesh,
    comm_close,
    comm_setup,
    distribute,
    gather,
    make_mesh,
    replicate,
    shard_rows,
)
from .stencil import ShardedGinzburgLandau, ShardedPoisson2D
from .bell import ShardedBellOperator

__all__ = [
    "ShardedBellOperator",
    "comm_setup",
    "comm_close",
    "make_mesh",
    "distribute",
    "replicate",
    "shard_rows",
    "gather",
    "Mesh",
    "ShardedPoisson2D",
    "ShardedGinzburgLandau",
]
