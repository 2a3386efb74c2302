"""Operator applications per solve: the program's counter of the cell's
operator (``bench_operator.matvec``, the label the loops give it), zeroed
before the window, over the solves of the window."""

COUNTERS = ("bench_operator.matvec",)


def read(run):
    return run.counters["bench_operator.matvec"] / run.steps if run.steps else None
