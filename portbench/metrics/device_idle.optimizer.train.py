"""The card's idle time while the train step is in its ``step.optimizer``
spans (``train/base_executor.py: apply_gradients``: the f32 gradients
collected, the update, the compute weights refreshed, the EMA), over the
traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.idle_share(run, ["step.optimizer"])
