"""The port's standalone phoneme predictor and vocabulary builder against the
JAX demo and script, on the CPU in f32.

``examples/phoneme_predictor.py`` and ``scripts/build_phoneme_vocab.py`` are
loaded from their files (they are scripts, not package modules). Flax
initializes the demo's weights; ``phoneme_predictor_from_flax`` copies them
into the port; the same ids go through both. The attention kernel's plain
version is also held against the Pallas kernel (interpret mode) at the
demo's attention shape, head dim 48.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import build_phoneme_vocab as t_vocab_cli
from phoneme_vqa_torch import phoneme_predictor as t_cli
from phoneme_vqa_torch.models import phoneme_predictor as t_pp
from phoneme_vqa_torch.ops import flash_attention as t_fa
from phoneme_vqa_torch.ops.attention import dot_product_attention as t_dpa
from phoneme_vqa_torch.phonology.vocab import VocabBuilder as TVocabBuilder
from phoneme_vqa_tpu.ops.attention import dot_product_attention as j_dpa
from phoneme_vqa_tpu.ops.flash_attention import fused_attention as j_fused
from phoneme_vqa_tpu.phonology.vocab import VocabBuilder as JVocabBuilder

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # f32 on both sides, sums in another order

SHORT = "xin chào việt nam"  # 4 tokens: the plain path on every device
# 16+ tokens (the kernel's gate), with a capitalised, a digit-bearing and a
# non-Vietnamese word split into characters
LONG = "Xin chào các bạn hôm nay trời đẹp quá 2024 wifi nghiêng ngả"


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO_ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # flax modules are dataclasses, resolved through sys.modules
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo():
    return _load("jax_phoneme_predictor_demo", "examples/phoneme_predictor.py")


@pytest.fixture(scope="module")
def vocab():
    builder = TVocabBuilder([])
    builder.add_text(SHORT + " " + LONG)
    return builder.vocab


def _flax(demo, vocab, **kw):
    """The demo's model and its flax init (which does not depend on the
    sentence's length: the positional table is no parameter)."""
    model = demo.MultiTokensPredictor(vocab, **kw)
    ids = jnp.asarray(demo.encode_sentence(vocab, SHORT))
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), ids))


@pytest.fixture(scope="module")
def tiny(demo, vocab):
    return _flax(demo, vocab, embed_dim=16, num_layers=2)


def test_vocab_builder_and_encode_sentence_equal_jax(demo, vocab):
    j_builder = JVocabBuilder([])
    j_builder.add_text(SHORT + " " + LONG)
    assert j_builder.vocab == vocab
    partial = {p: dict(list(ids.items())[:6]) for p, ids in vocab.items()}  # unknown parts -> 0
    for sentence in (SHORT, LONG, "VIỆT NAM", "abc123 x1 ok", "ngoằn ngoèo quốc 9"):
        for v in (vocab, partial):
            got, want = t_pp.encode_sentence(v, sentence), demo.encode_sentence(v, sentence)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    assert t_pp.encode_sentence(vocab, LONG).shape[1] >= 16


@pytest.mark.parametrize("sentence", [SHORT, LONG])
def test_tiny_width_log_probs_match_jax(demo, vocab, tiny, sentence):
    ids = demo.encode_sentence(vocab, sentence)
    model, params = tiny
    want = model.apply(params, jnp.asarray(ids))
    port = t_pp.phoneme_predictor_from_flax(params, vocab).eval()
    assert len(port.layers) == 2 and port.onset_embed.weight.shape[1] == 16
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    for part in t_pp.PARTS:
        assert got[part].dtype == torch.float32
        np.testing.assert_allclose(got[part].numpy(), np.asarray(want[part]), atol=ATOL, rtol=0)
    assert [tuple(r) for r in t_pp.argmax_parts(vocab, got)] == [
        tuple({i: t for t, i in vocab[p].items()}[int(np.argmax(np.asarray(want[p])[0, n]))]
              for p in t_pp.PARTS) for n in range(ids.shape[1])]


def test_default_width_log_probs_match_jax(demo, vocab):
    ids = demo.encode_sentence(vocab, LONG)
    model, params = _flax(demo, vocab)
    want = model.apply(params, jnp.asarray(ids))
    port = t_pp.phoneme_predictor_from_flax(params, vocab).eval()
    layer = port.layers[0]
    assert (len(port.layers), layer.num_heads, layer.head_dim, layer.fc1.out_features) == \
        (6, 8, 48, 2048)
    assert layer.ln1.eps == 1e-6
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    for part in t_pp.PARTS:
        np.testing.assert_allclose(got[part].numpy(), np.asarray(want[part]), atol=ATOL, rtol=0)


def test_model_dim_changes_nothing_as_in_jax(demo, vocab, tiny):
    ids = demo.encode_sentence(vocab, LONG)
    model, params = _flax(demo, vocab, d_model=48, embed_dim=16, num_layers=2)
    assert tiny[0].d_model == 384 and model.d_model == 48
    assert jax.tree.map(np.shape, params) == jax.tree.map(np.shape, tiny[1])
    outs = []
    for d_model in (48, 384):
        port = t_pp.MultiTokensPredictor(vocab, d_model=d_model, embed_dim=16, num_layers=2)
        t_pp.init_weights(port, torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(port(torch.from_numpy(ids)))
    for part in t_pp.PARTS:
        assert torch.equal(outs[0][part], outs[1][part])
    assert t_cli.main(["--sentence", LONG, "--model-dim", "48", "--device", "cpu"]) == \
        t_cli.main(["--sentence", LONG, "--device", "cpu"])


def test_bridge_raises_on_a_missing_or_an_extra_leaf(vocab, tiny):
    tree = tiny[1]["params"]
    missing = {**tree, "layer_1": {k: v for k, v in tree["layer_1"].items() if k != "fc2"}}
    with pytest.raises(KeyError, match="left over"):
        t_pp.phoneme_predictor_from_flax(missing, vocab)
    extra = {**tree, "tone_head": {**tree["tone_head"], "extra": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="tone_head/extra"):
        t_pp.phoneme_predictor_from_flax(extra, vocab)


def test_a_sentence_past_the_positional_table_raises(vocab):
    port = t_pp.MultiTokensPredictor(vocab, embed_dim=16, num_layers=1)
    with pytest.raises(ValueError, match="at most 512"):
        port(torch.zeros(1, t_pp.MAX_LEN + 1, 3, dtype=torch.int32))


def test_attention_at_head_dim_48_matches_the_pallas_kernel():
    """The demo's attention call (B=1, H=8, D=48, scale 48^-0.5, no bias, no
    mask) at 20 tokens: the port's wrapper on CPU tensors (its plain version)
    and its dispatch against the Pallas kernel in interpret mode and JAX's
    dispatch."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 8, 20, 48).astype(np.float32) for _ in range(3))
    scale = 48 ** -0.5
    want = np.asarray(j_fused(*map(jnp.asarray, (q, k, v)), scale=scale, interpret=True))
    np.testing.assert_allclose(np.asarray(j_dpa(*map(jnp.asarray, (q, k, v)), scale=scale)),
                               want, atol=ATOL, rtol=0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = t_fa.LAUNCHES
    for got in (t_fa.fused_attention(tq, tk, tv, scale=scale), t_dpa(tq, tk, tv, scale=scale)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert t_fa.LAUNCHES == before  # CPU tensors: the plain version, no launch


def test_vocab_cli_writes_the_jax_scripts_bytes(tmp_path, monkeypatch, capsys):
    anns = []
    for n, (question, answers) in enumerate((
            ("Biển báo ghi gì?", ["cấm đỗ xe"]),
            ("Cửa hàng tên là gì", ["Phở 24h"]),
            ("What is the wifi password?", "abc123 xyz"))):
        path = tmp_path / f"ann{n}.json"
        path.write_text(json.dumps({"annotations": [
            {"question": question, "answers": answers},
            {"question": "Số điện thoại là bao nhiêu?", "answers": ["0912 345 678"]}]},
            ensure_ascii=False), encoding="utf-8")
        anns.append(str(path))
    script = _load("jax_build_phoneme_vocab", "scripts/build_phoneme_vocab.py")
    want_out = str(tmp_path / "jax_vocab.json")
    monkeypatch.setattr(sys, "argv", ["build_phoneme_vocab.py", "--out", want_out, *anns])
    script.main()
    want_line = capsys.readouterr().out.replace(want_out, "OUT")
    got_out = str(tmp_path / "port_vocab.json")
    sizes = t_vocab_cli.main(["--out", got_out, *anns])
    assert capsys.readouterr().out.replace(got_out, "OUT") == want_line
    with open(got_out, "rb") as f, open(want_out, "rb") as g:
        assert f.read() == g.read()
    assert sizes == {p: len(ids) for p, ids in json.load(open(got_out, encoding="utf-8")).items()}


def test_predictor_cli_on_the_cpu_prints_a_line_a_token(vocab, tmp_path):
    vocab_file = tmp_path / "vocab.json"
    vocab_file.write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    argv = ["--sentence", LONG, "--vocab-file", str(vocab_file), "--device", "cpu",
            "--seed", "3"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "phoneme_vqa_torch.phoneme_predictor", *argv],
                       cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    n = t_pp.encode_sentence(vocab, LONG).shape[1]
    assert [line.split(":")[0] for line in lines] == [f"Token {i + 1}" for i in range(n)]
    assert lines == t_cli.main(argv)  # the seed fixes the weights


def test_predictor_cli_without_device_cpu_raises_with_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_cli.main(["--sentence", SHORT])
