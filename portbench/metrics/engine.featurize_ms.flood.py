"""The gathered engine's dispatcher: the mean length of its
``engine.featurize`` spans (``serving/engine.py: _dispatch_group``, the
requests' rows featurized against the OCR store) in the traced slice, ms a
batch."""

from portbench import program_trace


def read(run):
    return program_trace.mean_ms(run, "engine.featurize")
