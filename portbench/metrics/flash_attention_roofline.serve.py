"""The attention kernel under serving: the least time of the encodes of
the batches decoded during the traced slice (each bucket's calls from its
shape, ``flops.py``) over the device time of the kernels this pattern
names, in %. The batches are those the engine resolved in the slice
(``stats()["bucket_batches"]``), so the slice's edges can shift the count
by a batch or two."""

import re

from portbench import flops, trace

KERNEL = re.compile(r"attention_\w*kernel<.*DenseBias")


def read(run):
    if run.slice is None:
        return None
    device_ns = trace.matching_ns(run.slice.ops, KERNEL)
    s0, s1 = run.slice_stats
    if not device_ns:
        return None
    work_s = 0.0
    for bucket, n in s1["bucket_batches"].items():
        batches = n - s0["bucket_batches"].get(bucket, 0)
        work_s += batches * flops.bound_s(run.family.serve_calls(run.c, int(bucket)), "flash")
    return 100.0 * work_s / (device_ns / 1e9) if work_s else None
