"""The drivers a traffic mix can name (``"driver"`` in its file): each is
one file ``portbench/drivers/<name>.py``, found by that name, whose class
``Driver(run)`` has

* ``build()``: the system under test, built from the port (the executor
  the configuration names, the seeded weights through ``load_params``);
* ``warm()``: the cell's own shapes, counted as set-up;
* ``window()``: one measured window; sets ``run.t_first``,
  ``run.window_s``, ``run.e2e`` (the end-to-end values), ``run.attempted``,
  ``run.failed``, ``run.steady`` (the window's readings before a traced
  run's profiler slice) and, with ``--trace 1``, ``run.slice``;
* ``outputs()``: keeps what the output check needs, frees the program;
* ``numbers()``: the numbers the output check compares (``checks.py``);
* ``controls()``: the same numbers of the control and of the faults that
  set the upper readings of the limits (``control.py``).

This module holds what the drivers share.
"""

from __future__ import annotations

import gc
import time

FUTURE_TIMEOUT_S = 120.0


class Steady:
    """The window's readings before a traced run's profiler slice: its
    ``seconds``, ``ns`` (start, end on the ``time.time_ns()`` clock), and
    the train steps (``steps``), or the answers, each answer's decode steps
    (``steps``) and the engine's ``stats`` at its two ends."""

    def __init__(self, seconds, ns, steps=0, answers=0, stats=None):
        self.seconds, self.ns, self.steps, self.answers, self.stats = (seconds, ns, steps,
                                                                       answers, stats)


def decode_steps(row, eos: int) -> int:
    """The decode steps a served row needed: up to its first EOS, or all."""
    tokens = list(row)[1:]
    return tokens.index(eos) + 1 if eos in tokens else len(tokens)


class Served(str):
    """An answer string as the program detokenized it, with the token row
    it was detokenized from (``row``)."""

    row: list


def tag_rows(executor) -> None:
    """Every answer the executor detokenizes carries its token row: the
    served tokens are what the output check compares. The strings are the
    program's own."""
    decode = executor._decode_rows

    def tagged(rows):
        out = []
        for answer, row in zip(decode(rows), rows):
            s = Served(answer)
            s.row = list(row)
            out.append(s)
        return out

    executor._decode_rows = tagged


def check_names(model, spec) -> None:
    """The configuration's reference names every parameter the port's model
    has, at the same shape."""
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(s) for n, (s, _) in spec.items()}
    if have != want:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = [n for n in set(have) & set(want) if have[n] != want[n]][:5]
        raise RuntimeError(f"the port's parameters differ from the reference's: not in the port "
                           f"{missing}, not in the reference {extra}, shapes {shapes}")


def executor(run, mode: str):
    """The port's executor the configuration names, in ``mode`` ("train" or
    "serve"), holding the seeded weights; and the reference's spec of them."""
    import phoneme_vqa_torch.train  # noqa: F401  (registers the executors)
    from phoneme_vqa_torch.config import Config
    from phoneme_vqa_torch.utils.registry import EXECUTORS

    from portbench import weights

    cfg = run.family.port_config(run.cf, run.fixture.paths, run.tmp_path("save"), run.seed)
    ex = EXECUTORS.get(run.c["EXECUTOR"])(Config(cfg), mode, device=run.device)
    spec = run.family.reference.param_spec(run.c)
    check_names(ex.model, spec)
    ex.load_params(weights.make(spec, run.seed, run.device))
    return ex, spec


def free() -> None:
    """Returns what the dropped program state held to the card."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sleep_until(t: float) -> None:
    """Sleeps until ``time.perf_counter()`` reaches ``t``."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))
