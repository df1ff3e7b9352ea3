"""Whether torch.profiler records CUDA kernels after ``chip_smoke.py``
phase 23's steps, on the card (the port, ``phoneme_vqa_torch``).

    python scripts/probe_profiler_after_prefetch.py fresh|phase23|noexport

Each mode runs in a fresh process on full-width LaTr-base (phase 7's
config) and prints ``PROBE`` lines:

* ``fresh``: 3-, 1- and 3-step ``PROFILE_DIR`` traces (``maybe_trace``);
  after each, the trace's events / kernel records / attention-kernel
  records and one ``_split_time`` session on the T5-encoder attention
  call (its device ms; 0.0 when the profiler recorded no CUDA kernel).
* ``phase23``: the ``_split_time`` session before phase 23 and after each
  of its parts (``knobs_phase``, then ``numworkers_phase``).
* ``noexport``: a 3-step profile without the Chrome export, then the
  session.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import itertools  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from phoneme_vqa_torch.data.loader import batch_iterator  # noqa: E402
from phoneme_vqa_torch.ops import _build  # noqa: E402
from phoneme_vqa_torch.utils import profiling  # noqa: E402

MODE = sys.argv[1] if len(sys.argv) > 1 else "fresh"


def probe(tag, fn):
    ms = cs._split_time("", fn)["device_ms"]
    print(f"PROBE {MODE} {tag}: device_ms={ms or 0.0!r}", flush=True)


def count_trace(path):
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    attn = sum(1 for e in kernels if "attn::attention_" in str(e.get("name", "")))
    return len(events), len(kernels), attn


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(*cs.KERNELS)
    q, k, v, bias, mask, causal, scale = cs.serving_shapes()[1]
    call = lambda: cs.fa.fused_attention(q, k, v, bias, mask, causal, scale)
    with tempfile.TemporaryDirectory() as root:
        paths = cs.train_fixture(root)
        if MODE == "phase23":
            probe("baseline", call)
            log = cs.log

            def probing_log(msg):
                log(msg)
                if msg.startswith("phase 23"):
                    probe("after: " + msg[:40], call)

            cs.log = probing_log
            cs.knobs_phase(paths, root)
            cs.numworkers_phase(paths, root)
            return
        ex = cs.LaTrExecutor(cs.latr_train_config(paths, os.path.join(root, "k"), SAVE=False),
                             "train", device=cs.DEVICE)
        batches = list(itertools.islice(batch_iterator(
            ex.train_data, cs.TRAIN_BATCH, shuffle=True, seed=cs.SEED + 1, drop_last=True), 3))
        ex.train_step(batches[0][0])
        torch.cuda.synchronize()
        if MODE == "noexport":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                for b, _ in batches:
                    ex.train_step(b)
                torch.cuda.synchronize()
            attn = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and "attn::attention_" in e.name]
            print(f"PROBE {MODE} 3 steps: attention kernel records {len(attn)}", flush=True)
            probe("after the profile", call)
            return
        for n in (3, 1, 3):
            prof = os.path.join(root, f"trace_{n}_{len(os.listdir(root))}")
            cs.reset_launches()
            with profiling.maybe_trace(prof, "steps", cuda=True):
                for b, _ in batches[:n]:
                    ex.train_step(b)
                torch.cuda.synchronize()
            (trace,) = os.listdir(prof)
            print(f"PROBE {MODE} trace of {n} steps: launches {cs.launches()}, events / kernel "
                  f"records / attention records {count_trace(os.path.join(prof, trace))}",
                  flush=True)
            probe(f"after the trace of {n}", call)


if __name__ == "__main__":
    main()
