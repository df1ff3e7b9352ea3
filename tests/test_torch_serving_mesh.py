"""Serving over a (data, model) mesh, on the CPU over gloo at tiny widths in
f32 (``phoneme_vqa_torch.dryrun.run_mesh``'s serve mode, two spawned
processes a mesh), and the repair that serves beam and ``SAMPLE`` configs
through the gathered engine's eager decode:

* the gathered engine at ``{model: 2}`` and ``{data: 2}`` answers as the
  JAX ``ServingEngine`` on bridged weights and as the port's one-process
  engine (a lone request at the smallest bucket, then a burst), and the
  continuous engine as one process (``tests/test_continuous.py:491``);
  buckets round up to the data axis (``tests/test_serving.py:211``). The
  engines answer token rows here (each executor's ``_decode_rows`` swapped
  for the identity): the offline fallback tokenizer decodes only pieces
  its own instance has encoded, so a rank that featurized its rows alone
  may spell a piece from another rank's rows ``<unk>`` (strings are
  compared in the CLI test, where rank 0 featurizes every row);
* a follower killed mid-serving turns rank 0 unhealthy within the group
  timeout; the torchrun-style CLI answers stdin and every rank exits 0 on
  SIGTERM;
* beam search (CustomizedSaL, 3 beams) answers as the JAX engine, a
  ``SAMPLE`` engine as the executor's ``infer`` at the same call counter,
  and ``decodes_with_graphs`` is False, not a raise, for such an executor
  on the card;
* LoRA at model 2 (a step, and serving its adapter), adafactor with ZeRO-1
  at data 2 and the pool decode's mesh rule, each against one process.

Each spawn of two ranks takes ~10-15 s here (most of it importing).
"""

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.dryrun import run_mesh
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.serving import engine as t_engine
from phoneme_vqa_torch.serving.engine import decodes_with_graphs
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.serving import ServingEngine as JServingEngine

from .test_torch_serving_engine import TIMEOUT, family_pair, submit_all

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATHERED = dict(batch_size=4, max_wait_ms=50, max_answer_length=10)
GROUP_TIMEOUT_S = 8.0


@pytest.fixture(scope="module")
def latr(tmp_path_factory):
    """The JAX and port executors on one tiny YAML (bridged weights), the
    weights saved for the mesh's ranks, and what one process answers."""
    root = tmp_path_factory.mktemp("mesh_serve")
    j_ex, t_ex, t_cfg, reqs = family_pair("latr", root)
    init = str(root / "init.pt")
    torch.save({n: t.detach() for n, t in t_ex.state.params.items()}, init)
    for ex in (j_ex, t_ex):  # token rows, not strings (module docstring)
        ex._decode_rows = lambda rows: [[int(t) for t in r] for r in rows]
    with JServingEngine(j_ex, *j_ex.serve_frames, batch_size=4, max_wait_ms=20,
                        max_answer_length=10) as eng:
        jax_answers = submit_all(eng, reqs)
    with ServingEngine(t_ex, *t_ex.serve_frames, **GATHERED) as eng:
        one = submit_all(eng, reqs)
    infer = t_ex.infer(t_ex.val_data, 4, 10)
    del t_ex._decode_rows
    return dict(cfg=t_cfg, reqs=reqs, init=init, jax=jax_answers, one=one, infer=infer,
                root=root)


_RUNS = {}
# the training knobs each mesh's spawn runs an epoch of before it serves
TRAIN = {"model2": dict(LORA_RANK=2, LR=1e-3),
         "data2": dict(OPTIMIZER="adafactor", LR=1e-2, EVAL_CONTINUOUS=True, EVAL_BATCH_SIZE=3)}
MESHES = {"model2": {"model": 2}, "data2": {"data": 2, "zero1": True}}


def mesh_run(latr, mesh: str) -> dict:
    """One spawn of two ranks a mesh, shared by the module's tests: an
    epoch of the mesh's training knobs (LoRA rank 2 at model 2; adafactor
    under ZeRO-1 with the pool decode at data 2), then the serve mode on
    the bridged weights: the gathered engine (a lone request, then the
    rest), the continuous engine, and at model 2 the gathered engine
    serving the epoch's adapter, at data 2 the fault drill (rank 1 killed,
    rank 0's engine watched)."""
    if mesh not in _RUNS:
        root = latr["root"] / mesh
        common = dict(requests=[list(r) for r in latr["reqs"]], init=latr["init"],
                      max_answer=10, group_timeout_s=GROUP_TIMEOUT_S, rows=True)
        specs = [dict(common, waves=[1], batch_size=4, buckets=[1, 2], max_wait_ms=50),
                 dict(common, engine="continuous", num_slots=4, prefill_chunk=2, horizon=4)]
        if mesh == "model2":
            specs.append(dict(common, requests=adapter_requests(latr), batch_size=4,
                              adapters={"tuned": str(root)}))
        else:
            specs.append(dict(common, batch_size=4, kill_follower=True))
        config = {**latr["cfg"], **TRAIN[mesh], "SAVE": True, "SAVE_PATH": str(root),
                  "MESH": MESHES[mesh]}
        _RUNS[mesh] = run_mesh(config, 2, device="cpu", epochs=1, steps=0, beams=0, serve=specs,
                               timeout=300)
    return _RUNS[mesh]


def adapter_requests(latr) -> list:
    return [[i, q, a] for i, q in latr["reqs"][:3] for a in ("tuned", None)]


@pytest.mark.parametrize("mesh", ["model2", "data2"])
def test_engines_over_a_mesh_answer_as_jax_and_one_process(latr, mesh):
    gathered, continuous = mesh_run(latr, mesh)["serve"][:2]
    assert gathered[0]["answers"] == latr["jax"] == latr["one"]
    assert continuous[0]["answers"] == latr["infer"]
    rank0 = gathered[0]["stats"]
    assert rank0["decode"] == "eager" and "gloo" in rank0["decode_reason"]
    assert rank0["served"] == len(latr["reqs"]) and rank0["failed"] == 0
    # the lone request rode the smallest bucket: 1 at model 2, rounded up to
    # the data axis (2) at data 2; every rank stepped every batch
    assert rank0["bucket_batches"].get("2" if mesh == "data2" else "1") >= 1
    assert [r["stats"]["batches"] for r in gathered] == [rank0["batches"]] * 2
    dispatches = [r["stats"]["decode_dispatches"] for r in continuous]
    assert dispatches[0] == dispatches[1] > 0
    if mesh == "data2":  # each data rank prefilled the chunks of its 2 slots
        assert sum(r["stats"]["prefill_chunks"] for r in continuous) >= 3


def test_a_killed_follower_turns_rank_0_unhealthy(latr):
    drill = mesh_run(latr, "data2")["serve"][2][0]
    assert drill["answers"] == latr["one"]
    assert drill["unhealthy_reason"] is not None
    assert drill["seconds_to_unhealthy"] < GROUP_TIMEOUT_S, drill
    assert "unhealthy" in drill["request_after_death"] or "Error" in \
        drill["request_after_death"]


def test_buckets_round_up_to_the_data_axis():
    """As ``tests/test_serving.py:211`` pins the JAX engine's: buckets round
    up to the data axis, dedupe and end at ``batch_size``; a lone request
    decodes at the smallest (rounded) bucket."""

    class _Stub:
        mesh = types.SimpleNamespace(dp=2, tp=1)

        def __init__(self):
            self.calls = []

        def _make_dataset(self, rows, ocr, obj=None):
            return list(range(len(rows)))

        def infer(self, ds, bs, ml, return_scores=False):
            self.calls.append((len(ds), bs))
            return ["ans"] * len(ds)

    stub = _Stub()
    store = {1.0: None, 2.0: None}
    with ServingEngine(stub, store, batch_size=8, max_wait_ms=1, warmup=False,
                       buckets=[1, 3, 99]) as eng:
        assert eng.buckets == [2, 4, 8]
        assert eng.answer(1.0, "q", timeout=30) == "ans"
    assert stub.calls == [(1, 2)]
    with pytest.raises(ValueError, match="positive"):
        ServingEngine(stub, store, warmup=False, buckets=[0])
    with pytest.raises(ValueError, match="must divide the mesh's data axis"):
        ServingEngine(stub, store, batch_size=5, warmup=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_serve_cli_over_a_mesh_answers_and_drains_on_sigterm(latr, tmp_path):
    """``torchrun --nproc-per-node 2 -m phoneme_vqa_torch.serve`` as torchrun
    launches it (each rank's RANK, WORLD_SIZE, MASTER_ADDR / PORT): rank 0
    answers every stdin request with one process's confidence (the token
    rows' mean log-probability; the strings are not compared: the offline
    fallback tokenizer spells a piece only once its instance has encoded
    it, and an engine detokenizes a batch while its dispatcher may already
    have featurized the next); SIGTERM to every rank (torchrun forwards it
    to all) drains, and every rank exits 0."""
    cfg = latr["cfg"]
    preset = tmp_path / "mesh.json"
    preset.write_text(json.dumps({**cfg, "MESH": {"model": 2}}))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "phoneme_vqa_torch.serve", "--config-file", str(preset),
             "--ckpt", "none", "--device", "cpu", "--batch-size", "4", "--max-wait-ms", "20",
             "--confidence", "--group-timeout", "60"],
            cwd=REPO_ROOT, env=env, stdin=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in procs[0].stdout], daemon=True).start()
    try:
        for i, (img, q) in enumerate(latr["reqs"]):
            procs[0].stdin.write(json.dumps({"id": i, "image_id": img, "question": q}) + "\n")
        procs[0].stdin.flush()
        out = [json.loads(lines.get(timeout=TIMEOUT)) for _ in latr["reqs"]]
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0], [p.stderr.read()[-3000:] for p in procs]
    # one process on the same seeded serve-mode weights
    one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "serve", device="cpu")
    with ServingEngine(one, *one.serve_frames, confidence=True, **GATHERED) as eng:
        want = submit_all(eng, latr["reqs"])
    got = {o["id"]: o for o in out}
    assert sorted(got) == list(range(len(want)))
    assert [got[i]["confidence"] for i in range(len(want))] == [w["confidence"] for w in want]
    assert all(isinstance(o["answer"], str) for o in out)


# -- C1: beam and SAMPLE configs through the gathered engine ------------------------


def test_beam_engine_answers_as_the_jax_engine(tmp_path):
    j_ex, t_ex, _, reqs = family_pair("customized_sal_bpe", tmp_path, isgreedy=False,
                                      num_beam=3, DecodeTokenizer="CharTokenizer")
    with JServingEngine(j_ex, *j_ex.serve_frames, **GATHERED) as eng:
        want = submit_all(eng, reqs)
    with ServingEngine(t_ex, *t_ex.serve_frames, **GATHERED) as eng:
        got = submit_all(eng, reqs)
        s = eng.stats()
    assert got == want
    assert s["decode"] == "eager" and "beam" in s["decode_reason"] and not eng._decoders


def test_sample_engine_answers_as_infer_at_the_same_call_counter(latr):
    cfg = t_config.Config({**latr["cfg"], "SAMPLE": True, "TEMPERATURE": 1.0, "TOP_K": 5})
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    ex.load_params(torch.load(latr["init"], weights_only=True))
    want = ex.infer(ex.val_data, 4, 10)  # two calls: a batch of 4, then of 2
    ex._generate_fns.clear()  # the engine's first decode draws the first call's noise
    with ServingEngine(ex, *ex.serve_frames, warmup=False, **GATHERED) as eng:
        got = submit_all(eng, latr["reqs"])
        assert eng.stats()["decode"] == "eager"
    assert got == want
    assert len(set(want)) > 1  # sampled, not a constant answer


def test_decodes_with_graphs_is_false_for_sampling_on_the_card():
    stub = types.SimpleNamespace(model=object(), device=torch.device("cuda"),
                                 _decodes_greedy=lambda: False)
    assert decodes_with_graphs(stub) is False
    stub._decodes_greedy = lambda: True
    assert decodes_with_graphs(stub) is True


def test_the_control_link_keeps_one_group_timeout(monkeypatch):
    """An engine that asks the process's control link for another group
    timeout than the one it was built with is refused, not given the
    first one silently."""
    link = types.SimpleNamespace(timeout_s=8.0)
    monkeypatch.setattr(t_engine, "_LINK", link)
    assert t_engine.control_link(8) is link
    with pytest.raises(ValueError, match="8.0 s group timeout"):
        t_engine.control_link(9.0)


# -- the three parts of A15b on the training side -------------------------------------


def _one_process(latr, mesh: str):
    """The mesh's epoch in one process, from the same seeded init."""
    cfg = t_config.Config({**latr["cfg"], **TRAIN[mesh], "SAVE": False})
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    return ex, ex._train_epoch(1)


def _within_2_lr(got: dict, want: dict, lr: float) -> None:
    """Every element within 2 lr (a normalized first step of a gradient at
    rounding level), all but 0.1 % within rtol 1e-4 / atol 2e-5
    (``tests/test_torch_parallel.py``'s rule)."""
    apart = total = 0
    for name, value in want.items():
        gap = (got[name].detach().float() - value.detach().float()).abs()
        assert float(gap.max()) <= 2 * lr, name
        apart += int((gap > 2e-5 + 1e-4 * value.detach().float().abs()).sum())
        total += gap.numel()
    assert apart <= 1e-3 * total, (apart, total)


def test_lora_at_model_2_trains_and_serves_as_one_process(latr):
    """LoRA rank 2 over a TP-2 model: each split weight's adapter split with
    it, the whole factor's gradient summed over the model axis; an epoch's
    loss and adapters as one process's, and the adapter served over the
    mesh (the switch merging this rank's slices) as one process serves it."""
    from phoneme_vqa_torch.serve import load_adapter

    record = mesh_run(latr, "model2")
    one, loss = _one_process(latr, "model2")
    np.testing.assert_allclose(record["losses"][0], loss, rtol=1e-5)
    assert record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]
    saved = torch.load(record["checkpoint"], weights_only=True)["params"]

    def flat(tree):
        return {f"{n}.{k}": t for n, ad in tree.items() for k, t in ad.items()}

    _within_2_lr(flat(saved["lora"]), flat(one.state.lora), float(one._lr_schedule(0)))
    assert any(float(ad["b"].abs().max()) > 0 for ad in saved["lora"].values())
    # serving: one process, the same base and the adapter the mesh saved
    served = T_EXECUTORS.get(latr["cfg"].EXECUTOR)(latr["cfg"], "serve", device="cpu")
    served.load_params(torch.load(latr["init"], weights_only=True))
    served._decode_rows = lambda rows: [[int(t) for t in r] for r in rows]
    adapter = load_adapter(str(latr["root"] / "model2"))
    with ServingEngine(served, *served.serve_frames, adapters={"tuned": adapter},
                       **GATHERED) as eng:
        want = [eng.submit(i, q, adapter=a).result(timeout=TIMEOUT)
                for i, q, a in adapter_requests(latr)]
    got = record["serve"][2]
    assert got[0]["answers"] == want
    assert [r["stats"]["adapter_switches"] for r in got] == \
        [got[0]["stats"]["adapter_switches"]] * 2 and got[0]["stats"]["adapter_switches"] >= 2


def test_adafactor_zero1_and_the_pool_decode_at_data_2(latr):
    """Adafactor under ZeRO-1 at data 2 (the factored moments split with
    each parameter over the data axis): an epoch's loss, masters and
    moments as one process's, the state through a checkpoint bit for bit.
    With ``EVAL_CONTINUOUS`` and an eval batch of 3, which does not divide
    the axis, the mesh takes the pool decode (JAX's rule): the answers are
    one process's."""
    record = mesh_run(latr, "data2")
    one, loss = _one_process(latr, "data2")
    np.testing.assert_allclose(record["losses"][0], loss, rtol=1e-5)
    assert record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]
    saved = torch.load(record["checkpoint"], weights_only=True)
    _within_2_lr(saved["params"], one.state.params, float(one._lr_schedule(0)))
    for part in ("v_row", "v_col", "v"):
        for name, value in one.state.opt_state[part].items():
            torch.testing.assert_close(saved["opt_state"][part][name], value, rtol=1e-4,
                                       atol=1e-12)
    assert record["answers"] == one.infer(one.val_data, 3, int(one.config.max_eval_length))


def test_pool_decode_follows_the_jax_mesh_rule(latr):
    cfg = t_config.Config({**latr["cfg"], "EVAL_CONTINUOUS": True})
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    j_cfg = {**latr["cfg"], "EVAL_CONTINUOUS": True}
    for dp, tp, batch, pool in ((2, 1, 4, False), (2, 1, 3, True), (1, 2, 4, False),
                                (2, 2, 0, True), (1, 1, 4, True)):
        ex.mesh = types.SimpleNamespace(dp=dp, tp=tp)
        assert ex._use_pool_decode(batch) is pool, (dp, tp, batch)
        # the JAX executor's rule on the same mesh shape
        j_ex = types.SimpleNamespace(config=j_cfg, model=ex.model, mesh=types.SimpleNamespace(
            shape={"data": dp, "model": tp}, devices=np.zeros((dp, tp))))
        from phoneme_vqa_tpu.train.base_executor import BaseExecutor as JBase

        assert JBase._use_pool_decode(j_ex, batch) is pool, (dp, tp, batch)


def test_the_kernel_store_records_the_mesh_and_loads_under_another(tmp_path, monkeypatch,
                                                                    caplog):
    """``--aot`` over a mesh: the manifest records the mesh it was packed
    under; a store packed under another mesh (or none) loads, the
    difference logged; a library already in the build directory (rank 0's,
    before the other ranks load) is not written again."""
    import logging

    from phoneme_vqa_torch.ops import _build
    from phoneme_vqa_torch.serving import aot

    env = {"format": 1, "device_kind": "NVIDIA H100 80GB HBM3", "driver": "570.00",
           "cuda_toolkit": "Build cuda_12.8", "torch": torch.__version__,
           "nvcc_flags": " ".join(_build.NVCC_FLAGS)}
    monkeypatch.setattr(aot, "env_fingerprint", lambda: dict(env))
    built, store = tmp_path / "built", tmp_path / "store"
    built.mkdir()
    for name in aot.KERNELS:
        (built / aot.library_file(name)).write_bytes(b"\x7fELF stub library")
    model2 = types.SimpleNamespace(dp=1, tp=2)
    assert aot.pack(str(store), str(built), mesh=model2) == list(aot.KERNELS)
    manifest = json.loads((store / "manifest.json").read_text())
    assert manifest["mesh"] == {"data": 1, "model": 2, "world": 2}
    with caplog.at_level(logging.INFO):
        assert aot.load(str(store), str(tmp_path / "fresh"),
                        mesh=types.SimpleNamespace(dp=2, tp=1)) == list(aot.KERNELS)
    assert any("does not depend on the mesh" in r.message or "do not depend" in r.message
               for r in caplog.records)
    stamps = {n: os.stat(built / aot.library_file(n)).st_mtime_ns for n in aot.KERNELS}
    assert aot.load(str(store), str(built), mesh=model2) == list(aot.KERNELS)
    assert {n: os.stat(built / aot.library_file(n)).st_mtime_ns for n in aot.KERNELS} == stamps
