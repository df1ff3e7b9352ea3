"""Serving's share of the card's bf16 peak: the counted operations of each
row answered in the window before the traced slice (encode, cross K/V, the
decode steps the row needed, ``flops.py``), over its seconds times
989 TFLOP/s, in %."""

from collections import Counter

from portbench import flops


def read(run):
    if not run.steady.answers:
        return None
    work = sum(n * run.family.served_row_flops(run.c, steps)
               for steps, n in Counter(run.steady.steps).items())
    return 100.0 * work / (run.steady.seconds * flops.BF16_PEAK_FLOP_S)
