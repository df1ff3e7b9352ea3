"""Serving on the card beyond one greedy process: a beam search and a
``SAMPLE`` config answer through the gathered engine's eager decode as
``executor.infer`` does (sampling at the same call counter), and the
gathered and continuous engines over a mesh answer as one process: two
gloo processes sharing the card (at data 2 each replays its own CUDA
graphs; at model 2 gloo's collectives go through the host and nothing is
captured) and, with two cards, two NCCL ranks at model 2 whose graphs
hold the model axis's collectives. ``run_mesh``'s timeout fails a hang.

Every test here needs a CUDA card; each skips inside the ``cuda`` fixture
(or, for the NCCL mesh, inside the test when there is one card). The card
machine has no JAX, so run these without the repo's conftest (which
imports JAX):

    python -m pytest tests/test_torch_serving_mesh_gpu.py --noconftest -q
"""

import pytest
import torch

from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.config import Config
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.dryrun import run_mesh, tiny_latr_config
from phoneme_vqa_torch.serving import ServingEngine
from phoneme_vqa_torch.utils.registry import EXECUTORS

pytestmark = pytest.mark.gpu

MAX_ANSWER = 10
# head dim 64: the attention kernel's encode launches are real ones
WIDTHS = dict(d_kv=64, num_heads=2, d_model=128, d_ff=256, vit_hidden_size=128,
              vit_num_heads=2, vit_mlp_dim=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return synthetic.make_latr_fixture(tmp_path_factory.mktemp("serving_mesh_gpu"))


def config(paths, root, **over) -> dict:
    return tiny_latr_config(paths, str(root), **WIDTHS, SAVE=False, **over)


def requests(cfg) -> list:
    return [(r["image_id"], r["question"]) for r in synthetic.read_qa_csv(cfg["qa_val_path"])]


def rows(ex) -> None:
    ex._decode_rows = lambda r: [[int(t) for t in x] for x in r]


@pytest.mark.parametrize("knobs", [
    dict(EXECUTOR="CustomizedLaTr_Executor", MODEL_CLASS="CustomizedLaTr",
         MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", DecodeTokenizer="ByteTokenizer",
         n_head=2, num_decoder_layers=2, isgreedy=False, num_beam=3),
    dict(SAMPLE=True, TEMPERATURE=1.0, TOP_K=5)], ids=["beam", "sample"])
def test_beam_and_sample_serve_on_the_card_as_infer(cuda, paths, tmp_path, knobs):
    cfg = Config(config(paths, tmp_path, **knobs))
    ex = EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cuda")
    rows(ex)
    want = ex.infer(ex.val_data, 4, MAX_ANSWER)
    ex._generate_fns.clear()  # a sampled decode's call counter starts again
    with ServingEngine(ex, *ex.serve_frames, batch_size=4, max_wait_ms=50,
                       max_answer_length=MAX_ANSWER, warmup=False) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in requests(cfg)]]
        s = eng.stats()
    assert got == want
    assert s["decode"] == "eager" and not eng._decoders


def _mesh_serving(paths, root, backend: str, mesh: dict) -> tuple:
    cfg = config(paths, root, DTYPE="float32")
    reqs = [list(r) for r in requests(cfg)]
    one = EXECUTORS.get(cfg["EXECUTOR"])(Config(cfg), "serve", device="cuda")
    one._ensure_params()
    rows(one)
    with ServingEngine(one, *one.serve_frames, batch_size=4, max_wait_ms=50,
                       max_answer_length=MAX_ANSWER) as eng:
        want = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
        assert eng.stats()["decode"] == "graphs"  # one process's graph rows
    common = dict(requests=reqs, rows=True, max_answer=MAX_ANSWER)
    served = run_mesh(dict(cfg, MESH=mesh), 2, device="cuda", backend=backend, steps=0,
                      serve=[dict(common, batch_size=4, buckets=[1], waves=[1]),
                             dict(common, engine="continuous", num_slots=4, prefill_chunk=2,
                                  horizon=4)], timeout=300)["serve"]
    return want, served


@pytest.mark.parametrize("mesh,decode", [({"model": 2}, "eager"), ({"data": 2}, "graphs")],
                         ids=["model2", "data2"])
def test_engines_over_gloo_on_one_card_answer_as_one_process(cuda, paths, tmp_path, mesh,
                                                             decode):
    want, served = _mesh_serving(paths, tmp_path, "gloo", mesh)
    for ranks in served:
        assert ranks[0]["answers"] == want  # bit for bit one process's graph rows
        assert all(r["stats"]["decode"] == decode for r in ranks)
    # every rank launched the attention kernel in each batch's encode: the T5
    # encoder's 2 layers (the ViT's 5 positions stay plain, under 16)
    for r in served[0]:
        assert r["launches"]["flash_attention"] == 2 * r["stats"]["batches"] > 0
        assert r["stats"]["decode_chunks"] > 0 and r["decoder_bytes"]


def test_engines_over_nccl_answer_as_one_process(cuda, paths, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("an NCCL mesh needs two cards")
    want, served = _mesh_serving(paths, tmp_path, "nccl", {"model": 2})
    for ranks in served:
        assert ranks[0]["answers"] == want
        assert all(r["stats"]["decode"] == "graphs" for r in ranks)
        assert all("NCCL" in r["stats"]["decode_reason"] for r in ranks)
    # both model ranks left every batch's loop at the same chunk
    chunks = [r["stats"]["decode_chunks"] for r in served[0]]
    assert chunks[0] == chunks[1] > 0
