"""The card's idle time while the engine's resolver works on the host after
a batch's decode: the rows read back (``decode.readback``), detokenized
(``engine.detokenize``) and their futures completed (``engine.complete``),
over the traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.idle_share(
        run, ["decode.readback", "engine.detokenize", "engine.complete"])
