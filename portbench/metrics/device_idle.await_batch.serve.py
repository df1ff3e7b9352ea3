"""The card's idle time while the engine's resolver waits for the next
batch from the dispatcher (its ``engine.await_batch`` spans,
``serving/engine.py: _resolve_loop_inner``), over the traced slice, in %."""

from portbench import program_trace


def read(run):
    return program_trace.idle_share(run, ["engine.await_batch"])
