"""The attention kernel (``ops/flash_attention.py`` on
``csrc/attention_core.cuh``) in training: the least time its calls of the
traced steps could take (``flops.py``: each call's bound from its shape,
summed over a step's calls, times the steps traced) over the device time
of the kernels this pattern names, in %."""

import re

from portbench import flops, trace

KERNEL = re.compile(r"attention_\w*kernel<.*DenseBias")


def read(run):
    if run.slice is None or not getattr(run, "slice_steps", 0):
        return None
    device_ns = trace.matching_ns(run.slice.ops, KERNEL)
    if not device_ns:
        return None
    work_s = flops.bound_s(run.family.train_calls(run.c), "flash") * run.slice_steps
    return 100.0 * work_s / (device_ns / 1e9)
