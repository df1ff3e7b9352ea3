"""The SaL kernel (``ops/sal_fused_attention.py``) in training: as
``flash_attention_roofline.train``, over the kernels this pattern names."""

import re

from portbench import flops, trace

KERNEL = re.compile(r"attention_\w*kernel<.*SalBias")


def read(run):
    if run.slice is None or not getattr(run, "slice_steps", 0):
        return None
    device_ns = trace.matching_ns(run.slice.ops, KERNEL)
    if not device_ns:
        return None
    work_s = flops.bound_s(run.family.train_calls(run.c), "sal") * run.slice_steps
    return 100.0 * work_s / (device_ns / 1e9)
