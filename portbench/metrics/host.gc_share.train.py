"""The program's garbage collector: the seconds its collections took
(``utils/profiling.py: gc_stats``, every generation; a full collection stops
every thread) over the window before the traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.gc_share(run)
