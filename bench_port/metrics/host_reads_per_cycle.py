"""Host reads per cycle: the program's ``host_reads`` counter
(``utils/timer.py``: every wait of a solver on the device), zeroed before
the window, over the cycles of the window."""

COUNTERS = ("host_reads",)


def read(run):
    return run.counters["host_reads"] / run.steps if run.steps else None
