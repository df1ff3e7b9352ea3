"""The card's idle share of the traced slice: 1 - (the union of its
operations' intervals: kernels, copies, sets) / the slice's wall, in %."""

from portbench import trace


def read(run):
    if run.slice is None or run.slice.t1 <= run.slice.t0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.slice.ops) / (run.slice.t1 - run.slice.t0))
