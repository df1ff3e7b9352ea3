"""The gathered engine's dispatcher: the mean length of its
``engine.encode`` spans (``serving/engine.py: _infer_async``: the batch's
pixel reads, its copy to the card and the eager ViT and encoder launches of
``GraphDecoder.start``) in the traced slice, ms a batch."""

from portbench import program_trace


def read(run):
    return program_trace.mean_ms(run, "engine.encode")
