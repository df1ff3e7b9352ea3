"""The train loader's file reads: the ``loader.read`` spans of the traced
slice (``data/loader.py: make_image_loader``'s pixel files,
``data/sal.py: _load_features``' OCR and region feature files), ms a step."""

from portbench import program_trace


def read(run):
    return program_trace.per_step_ms(run, "loader.read")
