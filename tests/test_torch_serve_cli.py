"""The port's serving CLI (``python -m phoneme_vqa_torch.serve``) on the CPU:
a stdin/stdout round trip (gathered and continuous, with an access log),
an HTTP round trip (``/answer``, ``/stats``, ``/metrics``, ``/healthz``,
the error codes), the SIGTERM drain, ``--prime`` (which needs the card
unless ``--device cpu``), and the ``--aot`` kernel store's manifest (a
hit, an environment mismatch, a missing store, a library of other
sources), with a stub library standing in for nvcc's output.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import serve as t_serve
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.ops import _build
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.serving import aot
from phoneme_vqa_torch.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cli")
    paths = make_latr_fixture(root)
    yaml_path = tiny_latr_yaml(paths, str(root / "ck"), NUM_EPOCHS=1, SAVE=False,
                               max_eval_length=10, max_predict_length=10, DTYPE="float32")
    rows = synthetic.read_qa_csv(paths["val"])
    return yaml_path, [(r["image_id"], r["question"]) for r in rows]


def _cli(*args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "phoneme_vqa_torch.serve", *args],
                          cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                          timeout=300, **kw)


@pytest.mark.parametrize("mode", [[], ["--continuous", "--horizon", "4",
                                        "--prefill-chunk", "2"]])
def test_stdin_round_trip(served, tmp_path, mode):
    yaml_path, reqs = served
    lines = "".join(json.dumps({"id": i, "image_id": img, "question": q}) + "\n"
                    for i, (img, q) in enumerate(reqs))
    lines += "not json\n"
    access_log = str(tmp_path / "access.jsonl")
    r = _cli("--config-file", yaml_path, "--ckpt", "none", "--device", "cpu",
             "--batch-size", "4", "--max-wait-ms", "5", "--access-log", access_log, *mode,
             input=lines)
    assert r.returncode == 0, r.stderr[-2000:]
    out = [json.loads(line) for line in r.stdout.strip().splitlines()]
    answers = {o["id"]: o["answer"] for o in out if "answer" in o}
    assert set(answers) == set(range(len(reqs)))
    assert [o["id"] for o in out if "error" in o] == [len(reqs)]  # the line that is not JSON
    recs = [json.loads(line) for line in open(access_log, encoding="utf-8")]
    assert len(recs) == len(reqs) and all(rec["status"] == "ok" for rec in recs)
    assert sorted(rec["image_id"] for rec in recs) == sorted(img for img, _ in reqs)
    assert "question" not in recs[0]


def test_http_round_trip(served):
    """POST /answer batches concurrent requests through the engine; /stats,
    /metrics and /healthz answer; unknown images 404, bad bodies 400."""
    yaml_path, reqs = served
    config = t_config.get_config(yaml_path)
    ex = EXECUTORS.get(config.EXECUTOR)(config, "eval", device="cpu")
    want = ex.infer(ex.val_data, 4, 10)
    with ServingEngine(ex, *ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as eng:
        srv = t_serve.make_http_server(eng, 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_port}"

        def post(obj, path="/answer"):
            req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                         {"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=TIMEOUT).read())

        try:
            results = [None] * len(reqs)

            def worker(i, img, q):
                results[i] = post({"image_id": img, "question": q})

            threads = [threading.Thread(target=worker, args=(i, *r)) for i, r in enumerate(reqs)]
            [t.start() for t in threads]
            [t.join(timeout=TIMEOUT) for t in threads]
            assert [r["answer"] for r in results] == want
            assert json.loads(urllib.request.urlopen(base + "/healthz").read()) == {"ok": True}
            assert json.loads(urllib.request.urlopen(base + "/stats").read())["served"] >= 6
            metrics = urllib.request.urlopen(base + "/metrics").read().decode()
            assert "phonovqa_served_total" in metrics
            with pytest.raises(urllib.error.HTTPError) as ei:
                post({"image_id": "no-such", "question": "q"})
            assert ei.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(base + "/answer", b"not json"),
                                       timeout=30)
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                post({"question": "missing image_id"})
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                post({"ckpt": "other"}, "/reload")
            assert ei.value.code == 400
        finally:
            srv.shutdown()
            srv.server_close()


def test_sigterm_drains_and_exits_zero(served):
    yaml_path, reqs = served
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "phoneme_vqa_torch.serve", "--config-file", yaml_path,
         "--ckpt", "none", "--device", "cpu", "--http", str(port)],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                r = urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5)
                assert json.loads(r.read()) == {"ok": True}
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.5)
        else:
            raise AssertionError("the server never became healthy")
        body = json.dumps({"image_id": reqs[0][0], "question": reqs[0][1]}).encode()
        got = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/answer", body), timeout=TIMEOUT).read())
        assert "answer" in got
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=TIMEOUT)
        assert rc == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_prime_needs_the_card_unless_asked_for_the_cpu(served, tmp_path):
    """``--prime --device cpu`` exits 0 (``--aot`` is ignored there: the CPU
    path builds no kernels); without ``--device cpu`` and a card it raises."""
    yaml_path, _ = served
    r = _cli("--config-file", yaml_path, "--ckpt", "none", "--device", "cpu", "--prime",
             "--aot", str(tmp_path / "store"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "primed" in r.stderr
    assert "--aot ignored" in r.stderr and not (tmp_path / "store").exists()
    if torch.cuda.is_available():
        return
    r = _cli("--config-file", yaml_path, "--ckpt", "none", "--prime")
    assert r.returncode != 0 and "no CUDA card" in r.stderr


@pytest.fixture
def stub_env(monkeypatch):
    env = {"format": 1, "device_kind": "NVIDIA H100 80GB HBM3", "driver": "570.00",
           "cuda_toolkit": "Build cuda_12.8", "torch": torch.__version__,
           "nvcc_flags": " ".join(_build.NVCC_FLAGS)}
    monkeypatch.setattr(aot, "env_fingerprint", lambda: dict(env))
    return env


def test_aot_store_hit_mismatch_and_miss(tmp_path, stub_env, monkeypatch):
    built, store, fresh = tmp_path / "built", tmp_path / "store", tmp_path / "fresh"
    built.mkdir()
    stub = b"\x7fELF stub library"  # stands in for nvcc's output
    for name in aot.KERNELS:
        (built / aot.library_file(name)).write_bytes(stub)
    (built / "flash_attention_0000000000000000.so").write_bytes(b"old sources")
    assert aot.load(str(store), str(fresh)) == []  # a missing store is a clean miss
    assert aot.pack(str(store), str(built)) == list(aot.KERNELS)
    manifest = json.loads((store / "manifest.json").read_text())
    assert manifest["env"] == stub_env and set(manifest["kernels"]) == set(aot.KERNELS)
    assert not (store / "flash_attention_0000000000000000.so").exists()
    # a hit: the libraries land in the build directory, where _build finds them
    assert aot.load(str(store), str(fresh)) == list(aot.KERNELS)
    assert aot.built(build_dir=str(fresh)) == list(aot.KERNELS)
    assert (fresh / aot.library_file("flash_attention")).read_bytes() == stub
    # another environment: a miss, nothing copied
    other = tmp_path / "other"
    monkeypatch.setattr(aot, "env_fingerprint", lambda: dict(stub_env, driver="575.00"))
    assert aot.load(str(store), str(other)) == [] and not other.exists()
    # a library of other sources (its file name carries another hash): skipped
    monkeypatch.setattr(aot, "env_fingerprint", lambda: dict(stub_env))
    manifest["kernels"]["flash_attention"] = "flash_attention_0000000000000000.so"
    (store / "manifest.json").write_text(json.dumps(manifest))
    assert aot.load(str(store), str(tmp_path / "third")) == ["sal_fused_attention"]
    (store / "manifest.json").write_text("{not json")
    assert aot.load(str(store), str(tmp_path / "fourth")) == []
