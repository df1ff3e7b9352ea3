"""The card's idle time while the train step is in its ``step.backward``
spans (``train/base_executor.py: train_step``, ``profiling.backward``: the
autograd backward), over the traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.idle_share(run, ["step.backward"])
