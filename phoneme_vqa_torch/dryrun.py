"""The mesh lifecycle in separate processes (the port's twin of the root
``__graft_entry__.py: dryrun_multichip``).

    python -m phoneme_vqa_torch.dryrun --devices 4 [--device cpu|cuda]

:func:`dryrun_multichip` starts ``n`` processes (gloo on the CPU, NCCL on
the cards, one a card) on a ``MESH: {data: n / tp, model: tp}`` with ``tp =
2`` when ``n`` is even. Each runs, through a real executor, a train epoch,
greedy ``infer`` over the validation rows, beam search under the split
model, and a checkpoint written on the mesh and restored into it bit for
bit. :func:`run_mesh` is the general form: any
config, mesh, backend and step count; it returns rank 0's record (loss,
answers, token rows, the checkpoint's path) with every rank's ms a step,
peak memory and optimizer-state bytes. Its serve mode (``serve=``) builds a
serve-mode executor on every rank and answers a request list through the
gathered or the continuous engine over the mesh: rank 0 submits, the other
ranks follow. ``chip_smoke.py`` phases 25 and 26 and
``tests/test_torch_parallel.py`` and ``tests/test_torch_serving_mesh.py``
call it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .config import Config
from .data import synthetic


def tiny_latr_config(paths: dict, save_path: str, **over) -> dict:
    """A LaTr config at tiny widths (f32, dropout 0) over
    ``synthetic.make_latr_fixture``'s files."""
    cfg = {
        "EXECUTOR": "LaTr_Executor", "MODEL_CLASS": "LaTr", "MODEL_MOD_CONFIG_CLASS": "LaTr_config",
        "SAVE": True, "SAVE_PATH": save_path, "LR": 1e-3, "BETAS": [0.9, 0.98],
        "NUM_EPOCHS": 1, "TRAIN_BATCH_SIZE": 8, "EVAL_BATCH_SIZE": 8, "PREDICT_BATCH_SIZE": 8,
        "max_predict_length": 10, "max_eval_length": 8, "get_predict_score": True,
        "ocr_path": paths["ocr"], "base_img_path": paths["img"], "max_ocr_element": 8,
        "max_ocr_length": 12, "max_q_length": 8, "max_a_length": 10,
        "qa_train_path": paths["train"], "qa_val_path": paths["val"],
        "qa_predict_path": paths["predict"], "backbone_name": "VietAI/vit5-base",
        "max_2d_position_embeddings": 1024, "t5_vocab_size": 512, "d_model": 32, "d_kv": 8,
        "num_heads": 4, "d_ff": 64, "num_encoder_layers": 2, "num_t5_decoder_layers": 2,
        "dropout_rate": 0.0, "vit_image_size": 32, "vit_patch_size": 16, "vit_hidden_size": 32,
        "vit_num_layers": 2, "vit_num_heads": 4, "vit_mlp_dim": 64, "DTYPE": "float32",
    }
    cfg.update(over)
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _first_rows(ex, rows: int):
    """This data rank's share of the first ``rows`` training rows, as the
    train loop's interleaved shard takes them."""
    mesh = ex.mesh
    idx = np.arange(rows)
    if mesh is not None:
        idx = idx[mesh.dp_rank::mesh.dp]
    return ex.train_data.gather(idx)


def _beam_rows(ex, max_length: int, num_beams: int):
    from .data.loader import batch_iterator
    from .models.generate import decode_token_ids, make_beam_generate_fn
    from .models.generate import make_multi_head_beam_generate_fn

    model = ex.model
    if getattr(type(model), "decode_components", 1) == 3:
        bos, eos, pad = decode_token_ids(model)
        generate = make_multi_head_beam_generate_fn(model, max_length, num_beams, bos, eos, pad)
    else:
        generate = make_beam_generate_fn(model, max_length, num_beams)
    batch, _ = next(batch_iterator(ex.val_data, ex.config.EVAL_BATCH_SIZE, pad_final=True))
    with torch.inference_mode():
        return generate(ex._device_batch(batch)).tolist()


def _state_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    return state.numel() * state.element_size() if isinstance(state, torch.Tensor) else 0


def _flat(params: dict) -> dict:
    """A params tree, a LoRA ``{"base", "lora"}`` one flattened."""
    if set(params) != {"base", "lora"}:
        return params
    return {**params["base"], **{f"{n}.{k}": t for n, ad in params["lora"].items()
                                 for k, t in ad.items()}}


def _round_trip(ex) -> dict:
    """Write ``last_ckp`` from the mesh, read it back into this rank's parts:
    whether the parameters and the optimizer state come back bit for bit."""
    ex._save_checkpoint("last")
    restored = ex._localize(ex.ckpt.restore("last", ex.device))
    same_opt = True
    for part, tensors in ex.state.opt_state.items():
        if isinstance(tensors, dict):
            same_opt &= all(torch.equal(restored["opt_state"][part][n], t)
                            for n, t in tensors.items())
    got = _flat(restored["params"])
    return {"checkpoint": ex.ckpt._path("last"),
            "restored_bit_for_bit": all(torch.equal(got[n], t)
                                        for n, t in _flat(ex._ckpt_params()).items()),
            "restored_opt_bit_for_bit": same_opt}


def _serve_executor(config: dict, device: str, spec: dict):
    """The serve-mode executor of ``run_mesh``'s serve mode: ``config`` with
    ``spec["config"]`` over it, its seeded init or the full parameters at
    ``spec["init"]``, split over the mesh."""
    from .utils.registry import EXECUTORS

    cfg = Config({**config, **spec.get("config", {})})
    ex = EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device=device)
    if spec.get("init"):
        ex.load_params(torch.load(spec["init"], map_location=ex.device, weights_only=True))
    ex._ensure_params()
    ex.model.eval()
    if spec.get("rows"):  # answers as token rows (chip_smoke.py's rows_engine)
        ex._decode_rows = lambda rows: [list(r) for r in rows]
    return ex


def _serve(rank: int, ex, spec: dict, out: str) -> dict:
    """Serve mode on one rank (``run_mesh``'s ``serve``): the engine over
    the mesh; rank 0 answers ``spec["requests"]`` in waves (``spec["waves"]``
    requests at once, each wave after the last one's answers, then the
    rest), the other ranks follow. Returns this rank's record."""
    from .ops import flash_attention, sal_fused_attention
    from .serve import load_adapter
    from .serving import ContinuousEngine, ServingEngine

    kw = dict(max_answer_length=int(spec.get("max_answer", 10)),
              group_timeout_s=float(spec.get("group_timeout_s", 120.0)))
    t0 = time.perf_counter()
    if spec.get("engine", "gathered") == "continuous":
        engine = ContinuousEngine(ex, *ex.serve_frames, num_slots=int(spec.get("num_slots", 4)),
                                  prefill_chunk=int(spec.get("prefill_chunk", 2)),
                                  horizon=int(spec.get("horizon", 4)), max_queue=0, **kw)
    else:
        adapters = {name: load_adapter(path, ex.device)
                    for name, path in spec.get("adapters", {}).items()}
        engine = ServingEngine(ex, *ex.serve_frames, batch_size=int(spec.get("batch_size", 4)),
                               max_wait_ms=float(spec.get("max_wait_ms", 50)),
                               buckets=spec.get("buckets"), adapters=adapters or None, **kw)
    start_s = time.perf_counter() - t0
    kernels = (flash_attention, sal_fused_attention)
    for module in kernels:  # the warmup's launches are not the served batches'
        module.LAUNCHES = 0
    record = {"rank": rank, "engine_start_s": start_s}
    t0 = time.perf_counter()
    if rank == 0:
        reqs = [tuple(r) + (None,) * (3 - len(r)) for r in spec["requests"]]
        answers = []
        for n in [int(w) for w in spec.get("waves", ())] + [len(reqs)]:
            futures = [engine.submit(i, q, adapter=a) for i, q, a in
                       reqs[len(answers):len(answers) + n]]
            answers += [f.result(timeout=300) for f in futures]
        record.update(answers=answers, wall_s=time.perf_counter() - t0)
        if spec.get("kill_follower"):
            record.update(_after_a_follower_dies(engine, reqs[0], out, kw["group_timeout_s"]))
        engine.stop()
    else:
        engine.follow()
        record["wall_s"] = time.perf_counter() - t0
    stats = engine.stats()
    record.update(stats=stats, launches={m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                                         for m in kernels})
    return record


def _serve_all(rank: int, world: int, config: dict, device: str, specs: list, out: str):
    """Every spec of ``run_mesh``'s serve mode in turn over one serve-mode
    executor (the first spec's ``config`` and ``init``); [every rank's
    record] a spec (rank 0's alone after the fault drill)."""
    t0 = time.perf_counter()
    ex = _serve_executor(config, device, specs[0])
    build_s = time.perf_counter() - t0
    served = []
    for spec in specs:
        record = _serve(rank, ex, spec, out)
        if not served:
            record["executor_build_s"] = build_s
        if spec.get("kill_follower"):
            served.append([record])
            break
        records = [None] * world
        dist.all_gather_object(records, record)
        served.append(records)
    return served


def _after_a_follower_dies(engine, request, out: str, group_timeout_s: float) -> dict:
    """Rank 0 of the fault drill: once ``run_mesh`` has killed rank 1, the
    seconds until the engine turns unhealthy (its idle no-op, or the
    request sent meanwhile, finds the dead follower) and what a request
    then gets."""
    with open(out + ".served", "w"):
        pass
    deadline = time.monotonic() + 60
    while not os.path.exists(out + ".killed") and time.monotonic() < deadline:
        time.sleep(0.05)
    t0 = time.monotonic()
    try:
        outcome = repr(engine.submit(*request[:2]).exception(timeout=3 * group_timeout_s))
    except Exception as e:  # refused: the engine already knew
        outcome = repr(e)
    while engine.unhealthy_reason is None and time.monotonic() - t0 < 3 * group_timeout_s:
        time.sleep(0.05)
    return {"seconds_to_unhealthy": time.monotonic() - t0,
            "unhealthy_reason": engine.unhealthy_reason, "request_after_death": outcome}


def _worker(rank: int, world: int, port: int, config: dict, device: str, backend: str,
            init: str, epochs: int, steps: int, beams: int, checkpoint: bool, out: str,
            serve: list = None) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cuda":
        from .parallel import tensor_parallel

        tensor_parallel.SHARED_CARD_GLOO = backend == "gloo"
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    timeout = {} if not serve else {"timeout": timedelta(
        seconds=float(serve[0].get("group_timeout_s", 120.0)))}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, **timeout)
    try:
        from . import train  # noqa: F401  (registers the executors)
        from .ops import flash_attention, sal_fused_attention
        from .utils.registry import EXECUTORS

        if serve and not (epochs or steps):
            served = _serve_all(rank, world, config, device, serve, out)
            if rank == 0:
                with open(out, "w", encoding="utf-8") as f:
                    json.dump({"serve": served}, f)
            if serve[-1].get("kill_follower"):  # rank 1 is gone: no collective is left
                os._exit(0)
            return
        cfg = Config(config)
        ex = EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device=device)
        if init:
            ex.load_params(torch.load(init, map_location=ex.device, weights_only=True))
        batch = _first_rows(ex, int(cfg.TRAIN_BATCH_SIZE))
        cuda = ex.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(ex.device)
        losses = [ex._train_epoch(epoch) for epoch in range(1, epochs + 1)]
        # decoded at the weights after the epochs, before the timed steps
        answers = ex.infer(ex.val_data, int(cfg.EVAL_BATCH_SIZE), int(cfg.max_eval_length))
        rows = ex._get_generate_fn(int(cfg.max_eval_length))(
            ex._device_batch(ex.val_data.gather(np.arange(min(len(ex.val_data),
                                                              int(cfg.EVAL_BATCH_SIZE)))))
        ).tolist()
        beam = _beam_rows(ex, int(cfg.max_eval_length), beams) if beams else None
        result = _round_trip(ex) if checkpoint and not steps else {}
        ms = []
        kernels = (flash_attention, sal_fused_attention)
        for module in kernels:
            module.LAUNCHES = 0
        for i in range(steps):
            if cuda:
                torch.cuda.synchronize(ex.device)
            t0 = time.perf_counter()
            losses.append(float(ex.train_step(batch)))
            if cuda:
                torch.cuda.synchronize(ex.device)
            ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0 and checkpoint:  # the state after the first step
                result = _round_trip(ex)
        record = {"rank": rank, "backend": dist.get_backend(), "mesh": ex.mesh.describe(),
                  "ms_per_step": ms[1:] or ms, "opt_state_bytes": _state_bytes(ex.state.opt_state),
                  "param_bytes": _state_bytes(ex.state.params),
                  "launches_per_step": {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES / max(steps, 1)
                                        for m in kernels},
                  "peak_gb": torch.cuda.max_memory_allocated(ex.device) / 1e9 if cuda else None}
        records = [None] * world
        dist.all_gather_object(records, record)
        served = None
        if serve:  # then the serve mode, in the same processes
            del ex
            if cuda:
                torch.cuda.empty_cache()
            served = _serve_all(rank, world, config, device, serve, out)
        if rank == 0:
            with open(out, "w", encoding="utf-8") as f:
                json.dump({"losses": losses, "answers": answers, "rows": rows, "beam_rows": beam,
                           "ranks": records, **result,
                           **({"serve": served} if served else {})}, f)
        if serve and serve[-1].get("kill_follower"):  # rank 1 is gone: no collective is left
            os._exit(0)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_mesh(config: dict, world: int, device: str = "cuda", backend: str = None,
             init: str = None, epochs: int = 0, steps: int = 1, beams: int = 2,
             checkpoint: bool = True, timeout: float = 600.0, serve: list = None) -> dict:
    """Run the lifecycle of the module docstring in ``world`` processes on
    ``config`` (which holds its ``MESH``): from the full parameters saved
    at ``init`` (else the seeded init, or a checkpoint the executor resumes
    from ``SAVE_PATH``), ``epochs`` epochs of ``_train_epoch``; ``infer``
    over the validation rows, greedy rows of its first batch and
    ``beams``-beam rows (0: none); then ``steps`` timed steps on the first
    batch. With ``checkpoint`` the state after the epochs, or after the
    first step, goes through ``last_ckp`` and back. Returns rank 0's
    record. A rank that fails, or a run past ``timeout`` seconds, raises.

    ``serve``: a list of specs, then (or, with ``epochs`` and ``steps`` 0,
    only) the serve mode of :func:`_serve` for each in turn; the record's
    ``"serve"`` holds, a spec, every rank's record (rank 0's: the answers,
    in request order). A spec's keys: ``requests``
    ([image_id, question(, adapter)]), ``engine`` (``gathered`` or
    ``continuous``), ``config`` (keys over ``config`` for the serve-mode
    executor), ``init`` (full parameters), ``rows`` (answers as token
    rows), ``waves``, ``batch_size``, ``buckets``, ``max_wait_ms``,
    ``max_answer``, ``adapters`` ({name: a LoRA run's SAVE_PATH}),
    ``num_slots``, ``prefill_chunk``, ``horizon``, ``group_timeout_s`` (the
    groups' timeout: one for every spec of a run) and ``kill_follower``
    (the fault drill: after the answers rank 1 is killed, and rank 0
    reports the seconds until its engine turns unhealthy)."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [ctx.Process(target=_worker, args=(rank, world, port, dict(config), device,
                                                   backend, init, epochs, steps, beams,
                                                   checkpoint, out, serve))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        if serve and serve[-1].get("kill_follower"):
            while not os.path.exists(out + ".served") and time.monotonic() < deadline:
                if any(p.exitcode for p in procs):
                    break
                time.sleep(0.05)
            os.kill(procs[1].pid, signal.SIGKILL)
            procs[1].join(10)
            with open(out + ".killed", "w"):
                pass
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        if serve and serve[-1].get("kill_follower"):
            codes[1] = 0 if codes[1] == -signal.SIGKILL else codes[1]
        if alive or any(codes):
            raise RuntimeError(f"mesh run failed: exit codes {codes}"
                               + (" (timed out)" if alive else ""))
        with open(out, encoding="utf-8") as f:
            record = json.load(f)
    return record


def dryrun_multichip(n_devices: int, device: str = "cuda", root: str = None) -> dict:
    """The lifecycle on a tiny LaTr over ``n_devices`` processes, ``tp = 2``
    when ``n_devices`` is even; prints one line a stage and returns the
    record."""
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        paths = synthetic.make_latr_fixture(tmp)
        config = tiny_latr_config(paths, os.path.join(tmp, "ckpts"), TRAIN_BATCH_SIZE=2 * dp,
                                  EVAL_BATCH_SIZE=2 * dp, MESH={"data": dp, "model": tp})
        record = run_mesh(config, n_devices, device=device, epochs=1, steps=0)
    print(f"dryrun_multichip({n_devices}): mesh=(data={dp}, model={tp}) over "
          f"{record['ranks'][0]['backend']}, executor train epoch loss={record['losses'][0]:.4f} "
          "OK")
    print(f"dryrun_multichip({n_devices}): greedy decode {len(record['answers'])} answers OK")
    print(f"dryrun_multichip({n_devices}): beam search rows {len(record['beam_rows'])} under "
          f"model={tp} OK")
    if not (record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]):
        raise AssertionError("the checkpoint written on the mesh did not restore bit for bit")
    print(f"dryrun_multichip({n_devices}): checkpoint round trip bit for bit OK")
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.dryrun")
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        raise SystemExit(f"--devices {args.devices} needs as many cards, have "
                         f"{torch.cuda.device_count()} (or pass --device cpu)")
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    main()
