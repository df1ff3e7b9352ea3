"""The serving graphs on the card: each bucket's captured decode replays bit
for bit the eager greedy decode of ``executor.infer`` (the stock T5, custom
and triple decoders; bf16 and f32), the continuous engine's dispatch graph
answers as ``infer`` does in f32, a capture that fails raises, and a reload
under captured graphs answers with the new weights.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
when there is none. The card machine has no JAX, so run these without the
repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_serving_gpu.py --noconftest -q
"""

import os
import subprocess
import sys

import pytest
import torch

from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.config import Config
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.data.loader import batch_iterator
from phoneme_vqa_torch.models.generate import build_generate_fn
from phoneme_vqa_torch.serving import ContinuousEngine, GraphDecoder, ServingEngine
from phoneme_vqa_torch.utils.registry import EXECUTORS

pytestmark = pytest.mark.gpu

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_ANSWER = 12
# narrow LaTr-family widths (head dim 64: the attention kernel's encode
# launches are real ones)
WIDTHS = dict(t5_vocab_size=512, d_model=128, d_kv=64, num_heads=2, d_ff=256,
              num_encoder_layers=2, num_t5_decoder_layers=2, dropout_rate=0.0,
              vit_image_size=32, vit_patch_size=16, vit_hidden_size=128, vit_num_layers=2,
              vit_num_heads=2, vit_mlp_dim=256, max_2d_position_embeddings=1024)
DECODERS = {
    "latr": dict(EXECUTOR="LaTr_Executor", MODEL_CLASS="LaTr",
                 MODEL_MOD_CONFIG_CLASS="LaTr_config"),
    "customized_latr": dict(EXECUTOR="CustomizedLaTr_Executor", MODEL_CLASS="CustomizedLaTr",
                            MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config",
                            DecodeTokenizer="ByteTokenizer", n_head=2, num_decoder_layers=2),
    "phoneme_latr": dict(EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
                         MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", n_head=2,
                         num_decoder_layers=2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_gpu")
    paths = synthetic.make_latr_fixture(root, n_images=3, n_rows=12)
    ann = os.path.join(str(root), "annotations.json")
    import json

    with open(ann, "w", encoding="utf-8") as f:
        json.dump({"annotations": [{"question": q, "answers": [a]} for q, a in
                                   zip(synthetic.QUESTIONS, synthetic.ANSWERS)]},
                  f, ensure_ascii=False)
    paths["annotations"] = ann
    return paths


def executor(paths, kind, dtype, mode="train", **over):
    config = Config({**dict(
        WIDTHS, **DECODERS[kind], SAVE=False, SAVE_PATH=os.path.join(paths["root"], kind),
        LR=1e-3, BETAS=[0.9, 0.98], warmup_step=10, NUM_EPOCHS=1, TRAIN_BATCH_SIZE=8,
        EVAL_BATCH_SIZE=8, PREDICT_BATCH_SIZE=8, max_predict_length=MAX_ANSWER,
        max_eval_length=MAX_ANSWER, get_predict_score=True, ocr_path=paths["ocr"],
        max_ocr_element=8, max_ocr_length=12, max_q_length=8, max_a_length=MAX_ANSWER,
        base_img_path=paths["img"], qa_train_path=paths["train"], qa_val_path=paths["val"],
        qa_predict_path=paths["predict"], backbone_name="VietAI/vit5-base", DTYPE=dtype,
        SEED=0, vocab_path=os.path.join(paths["root"], "phoneme_vocab.json"),
        annotation_paths=[paths["annotations"]]), **over})
    return EXECUTORS.get(config.EXECUTOR)(config, mode, device="cuda")


def requests(config):
    return [(r["image_id"], r["question"]) for r in synthetic.read_qa_csv(config.qa_val_path)]


@pytest.mark.parametrize("kind", list(DECODERS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graph_replay_is_bit_equal_to_the_eager_decode(cuda, paths, kind, dtype):
    """Per bucket (1, 4, 8), with and without scores: the rows of a replay
    equal the eager generate's bit for bit, and the scores too."""
    ex = executor(paths, kind, dtype)
    model = ex.model.eval()
    stream = torch.cuda.Stream()
    pool = torch.cuda.graph_pool_handle()
    for bucket in (1, 4, 8):
        batch, _ = next(batch_iterator(ex.val_data, bucket, pad_final=True))
        tb = ex._device_batch(batch)
        for with_scores in (False, True):
            want = build_generate_fn(model, MAX_ANSWER, with_scores)(tb)
            with torch.cuda.stream(stream):
                decoder = GraphDecoder(model, tb, MAX_ANSWER, with_scores, pool)
                assert decoder.graphs is not None
                got = decoder.start(tb)()
                again = decoder.start(tb)()  # a second replay over reloaded buffers
            torch.cuda.synchronize()
            for w, g, a in zip(*(x if with_scores else (x,) for x in (want, got, again))):
                assert torch.equal(g, w), (kind, dtype, bucket, with_scores)
                assert torch.equal(a, w)


@pytest.mark.parametrize("kind", list(DECODERS))
def test_engines_answer_as_infer_through_their_graphs(cuda, paths, kind):
    """f32: the gathered engine (buckets 1, 4) and the continuous engine
    (one dispatch graph) answer every request as ``infer`` does."""
    ex = executor(paths, kind, "float32")
    reqs = requests(ex.config)
    want = ex.infer(ex.val_data, 4, MAX_ANSWER)
    with ServingEngine(ex, *ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=MAX_ANSWER, buckets=[1]) as eng:
        assert set(eng._decoders) == {1, 4}
        got = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
    assert got == want
    with ContinuousEngine(ex, *ex.serve_frames, num_slots=3, prefill_chunk=2, horizon=4,
                          max_answer_length=MAX_ANSWER) as eng:
        assert eng._graph is not None
        got = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
    assert got == want


@pytest.mark.parametrize("engine_kind", ["gathered", "continuous"])
def test_reload_under_captured_graphs_answers_with_the_new_weights(cuda, paths, tmp_path,
                                                                   engine_kind):
    ex = executor(paths, "latr", "float32", SAVE_PATH=str(tmp_path))
    ex._save_checkpoint("best")
    # a train-mode twin: its offline tokenizer has encoded the answers ex's has
    served = executor(paths, "latr", "float32", SAVE_PATH=str(tmp_path))
    served._load_trained_checkpoint("best")
    reqs = requests(ex.config)
    make = (lambda: ServingEngine(served, *served.serve_frames, batch_size=4, max_wait_ms=20,
                                  max_answer_length=MAX_ANSWER)) if engine_kind == "gathered" \
        else (lambda: ContinuousEngine(served, *served.serve_frames, num_slots=3,
                                       prefill_chunk=2, horizon=4,
                                       max_answer_length=MAX_ANSWER))
    with make() as eng:
        before = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
        g = torch.Generator(device="cuda").manual_seed(99)
        ex.load_params({n: torch.randn(p.shape, generator=g, device="cuda") * 0.5
                        for n, p in ex.state.params.items()})
        ex._save_checkpoint("best")
        eng.reload("best")
        after = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
    want = ex.infer(ex.val_data, 4, MAX_ANSWER)
    assert after == want
    assert after != before


def test_a_failed_capture_raises(cuda, paths):
    """A decode step that reads the device from the host cannot be captured:
    the engine raises instead of falling back to the eager loop. In a fresh
    process: a failed capture leaves torch's CUDA generator registered to
    the dead graph, which would trip the draws of later tests."""
    code = (
        "import sys\n"
        "from tests.test_torch_serving_gpu import MAX_ANSWER, ServingEngine, executor\n"
        f"paths = {dict(paths)!r}\n"
        "ex = executor(paths, 'latr', 'bfloat16')\n"
        "real = ex.model.decode_step\n"
        "def syncing_step(*a, **kw):\n"
        "    logits, cache = real(*a, **kw)\n"
        "    float(logits[0, 0])  # a host read inside the capture\n"
        "    return logits, cache\n"
        "ex.model.decode_step = syncing_step\n"
        "try:\n"
        "    ServingEngine(ex, *ex.serve_frames, batch_size=4, max_answer_length=MAX_ANSWER)\n"
        "except RuntimeError as e:  # torch.AcceleratorError is one\n"
        "    print('raised a RuntimeError:', type(e).__name__)\n"
        "    sys.exit(0)\n"
        "sys.exit('the engine served without its graphs')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "raised a RuntimeError" in out.stdout, out.stderr[-3000:]
