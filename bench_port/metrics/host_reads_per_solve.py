"""Host reads per solve: the program's ``host_reads`` counter, zeroed
before the window, over the solves of the window."""

COUNTERS = ("host_reads",)


def read(run):
    return run.counters["host_reads"] / run.steps if run.steps else None
