"""Collectives per cycle on rank 0: the program's counters ``all_reduces``
(the vector layer's reductions) and ``operator_collectives`` (the halo
gathers), zeroed before the window, over the cycles of the window."""

COUNTERS = ("all_reduces", "operator_collectives")


def read(run):
    if not run.steps or run.world == 1:
        return None
    return (run.counters["all_reduces"] + run.counters["operator_collectives"]) / run.steps
