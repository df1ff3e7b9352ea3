"""The whole train step's share of the card's bf16 peak: the counted
matrix-product operations of a step (``flops.py``) times the steps of the
window before the traced slice, over its seconds times 989 TFLOP/s, in %."""

from portbench import flops


def read(run):
    if not run.steady.steps:
        return None
    work = run.family.train_step_flops(run.c) * run.steady.steps
    return 100.0 * work / (run.steady.seconds * flops.BF16_PEAK_FLOP_S)
