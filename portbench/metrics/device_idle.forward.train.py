"""The card's idle time while the train step is in its ``step.forward``
spans (``train/base_executor.py: forward_loss``: the forward and the loss,
launched from the host), over the traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.idle_share(run, ["step.forward"])
