"""The port's HF weight import (``phoneme_vqa_torch/models/hf_import.py``) on
the CPU: tiny HF T5 and ViT models, built offline with seeded weights, are
imported into the port. Their logits and encodings match HF's within 2e-4,
and the imported parameters equal the JAX package's import of the same state
dict (carried over by the weight bridge) within 1e-6. Also: greedy generate
equals HF's, a shape mismatch is loud, the report is clean on a match, the
safetensors reader round-trips the sandbox writer's files, and
``pretrained_weights_path`` works through the executor.
"""

import json
import os
import struct
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch.decode.greedy import greedy_decode
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import hf_import as t_hf
from phoneme_vqa_torch.models.t5 import T5 as TorchT5, T5Config as TorchT5Config
from phoneme_vqa_torch.models.vit import ViT as TorchViT, ViTConfig as TorchViTConfig
from phoneme_vqa_torch.train.latr_executor import LaTrExecutor
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.models import hf_import as j_hf
from phoneme_vqa_tpu.models.t5 import T5 as JaxT5, T5Config as JaxT5Config
from phoneme_vqa_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

transformers = pytest.importorskip("transformers")

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "latr_base_hf_manifest.json")
# configs/latr.yaml: vit5-base (T5 768 / 12 heads / d_kv 64 / d_ff 3072 /
# 12 + 12 layers / vocab 36096, gated-gelu, tied head) and ViT-base 224/16
LATR_BASE_T5 = dict(vocab_size=36096, d_model=768, d_kv=64, num_heads=12, d_ff=3072,
                    num_layers=12, num_decoder_layers=12, feed_forward_proj="gated-gelu",
                    tie_word_embeddings=True)
LATR_BASE_VIT = dict(image_size=224, patch_size=16, hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, intermediate_size=3072)
HF_TOL = 2e-4
JAX_TOL = 1e-6
T5_DIMS = dict(vocab_size=48, d_model=32, d_kv=8, num_heads=4, d_ff=37, num_layers=2,
               num_decoder_layers=2)


def hf_t5(tied: bool, ffn: str, seed: int = 0, **over):
    from transformers import T5Config, T5ForConditionalGeneration

    cfg = T5Config(**{**T5_DIMS, **over}, feed_forward_proj=ffn, dropout_rate=0.0,
                   tie_word_embeddings=tied, decoder_start_token_id=0)
    torch.manual_seed(seed)
    return T5ForConditionalGeneration(cfg).eval()


def hf_vit(seed: int = 1, **over):
    from transformers import ViTConfig, ViTModel

    cfg = ViTConfig(**{**dict(image_size=32, patch_size=16, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64), **over},
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return ViTModel(cfg, add_pooling_layer=False).eval()


def latr_base_manifest() -> dict:
    """The tensors that transformers' ``save_pretrained`` writes for
    ``configs/latr.yaml``'s T5 (``t5/model.safetensors``) and ViT
    (``vit/pytorch_model.bin``): each key with its full-width shape, f32.
    The keys come from a narrow model of the same depth saved for real (the
    tied aliases are not written), the shapes from the full-width model on
    the meta device. ``chip_smoke.py`` phase 18 writes seeded checkpoints
    from this manifest."""
    from transformers import T5Config, T5ForConditionalGeneration, ViTConfig, ViTModel

    out = {}
    for name, cls, cfg_cls, full, narrow, safe, extra in (
            ("t5", T5ForConditionalGeneration, T5Config, LATR_BASE_T5,
             dict(d_model=16, d_kv=4, num_heads=4, d_ff=32, vocab_size=64), True, {}),
            ("vit", ViTModel, ViTConfig, LATR_BASE_VIT,
             dict(hidden_size=16, num_attention_heads=4, intermediate_size=32), False,
             {"add_pooling_layer": False})):
        with tempfile.TemporaryDirectory() as d:
            cls(cfg_cls(**{**full, **narrow}), **extra).save_pretrained(d, safe_serialization=safe)
            keys = set(t_hf._load_state_dict(d))
        with torch.device("meta"):
            shapes = {k: list(v.shape) for k, v in cls(cfg_cls(**full), **extra).state_dict().items()}
        out[name] = {"file": "model.safetensors" if safe else "pytorch_model.bin",
                     "config": full, "dtype": "float32",
                     "tensors": [[k, shapes[k]] for k in sorted(keys)]}
    return out


def test_the_chip_manifest_is_what_transformers_writes():
    with open(MANIFEST, encoding="utf-8") as f:
        assert json.load(f) == latr_base_manifest()


def numpy_sd(module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def port_t5(tied: bool, ffn: str, vocab: int = 48) -> TorchT5:
    cfg = TorchT5Config(**{**T5_DIMS, "vocab_size": vocab}, dropout_rate=0.0,
                        feed_forward_proj="gated-gelu" if ffn == "gated-gelu" else "relu",
                        tie_word_embeddings=tied, dtype=torch.float32)
    torch.manual_seed(5)
    return TorchT5(cfg, device="cpu").eval()


def load_into(model, params) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


def jax_t5_import(tied: bool, ffn: str, sd: dict):
    cfg = JaxT5Config(**{**T5_DIMS}, dropout_rate=0.0, feed_forward_proj=ffn,
                      tie_word_embeddings=tied, dtype=jnp.float32)
    model = JaxT5(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32)),
                        jnp.zeros((1, 2), jnp.int32), None)["params"]
    return j_hf.import_t5_params(params, sd)


T5_CASES = [(True, "gated-gelu"), (False, "gated-gelu"), (True, "relu"), (False, "relu")]


@pytest.mark.parametrize("tied,ffn", T5_CASES)
def test_t5_import_matches_hf_logits_and_the_jax_import(tied, ffn):
    hf = hf_t5(tied, ffn)
    sd = numpy_sd(hf)
    model = port_t5(tied, ffn)
    params = dict(model.named_parameters())
    report = t_hf.ImportReport()
    imported = t_hf.import_t5_params(params, sd, report=report, prefix="", strict=True)
    load_into(model, imported)
    assert not report.failed
    b, l_enc, t = 2, 6, 5
    rng = np.random.RandomState(0)
    enc_ids, dec_ids = rng.randint(2, 48, (b, l_enc)), rng.randint(2, 48, (b, t))
    enc_mask = np.ones((b, l_enc), np.int64)
    enc_mask[1, 4:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(enc_ids), attention_mask=torch.tensor(enc_mask),
                  decoder_input_ids=torch.tensor(dec_ids)).logits.numpy()
        enc_out = model.encode(model.embed(torch.tensor(enc_ids)), torch.tensor(enc_mask))
        got = model.decode(torch.tensor(dec_ids), enc_out, torch.tensor(enc_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=HF_TOL, atol=HF_TOL)

    # the JAX import of the same state dict, bridged, gives the same masters
    j_params = jax_t5_import(tied, ffn, sd)
    bridged = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_params), model)
    for name, value in bridged.items():
        np.testing.assert_allclose(imported[name].detach().numpy(), value.numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)


@pytest.mark.parametrize("tied", [True, False])
def test_greedy_generate_equals_hf(tied):
    hf = hf_t5(tied, "gated-gelu", seed=3)
    model = port_t5(tied, "gated-gelu")
    load_into(model, t_hf.import_t5_params(dict(model.named_parameters()), numpy_sd(hf),
                                           prefix="", strict=True))
    rng = np.random.RandomState(4)
    enc_ids = rng.randint(2, 48, (3, 7))
    enc_mask = np.ones((3, 7), np.int64)
    enc_mask[2, 5:] = 0
    n = 10
    with torch.no_grad():
        want = hf.generate(input_ids=torch.tensor(enc_ids), attention_mask=torch.tensor(enc_mask),
                           max_new_tokens=n - 1, do_sample=False, num_beams=1).numpy()
        mask = torch.tensor(enc_mask)
        enc_out = model.encode(model.embed(torch.tensor(enc_ids)), mask)
        cache, full_bias = model.init_cache(enc_out, n)
        got = greedy_decode(lambda tok, c, i: model.decode_step(tok, c, i, full_bias, mask),
                            cache, 3, n, 0, 1, 0, "cpu").numpy()
    for w, g in zip(want, got):
        w = list(w) + [0] * (n - len(w))
        stop = w.index(1) + 1 if 1 in w else n
        assert list(g[:stop]) == w[:stop]


def test_vit_import_matches_hf_and_the_jax_import():
    hf = hf_vit()
    sd = numpy_sd(hf)
    model = TorchViT(TorchViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                                    num_heads=4, mlp_dim=64, dtype=torch.float32),
                     device="cpu").eval()
    report = t_hf.ImportReport()
    imported = t_hf.import_vit_params(dict(model.named_parameters()), sd, report=report,
                                      prefix="", strict=True)
    assert not report.failed and not report.unused
    assert len(report.mapped) == len(sd)
    load_into(model, imported)
    pix = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.tensor(pix)).last_hidden_state.numpy()
        got = model(torch.tensor(pix)).numpy()
    np.testing.assert_allclose(got, want, rtol=HF_TOL, atol=HF_TOL)

    j_model = JaxViT(JaxViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                                  num_heads=4, mlp_dim=64, dtype=jnp.float32))
    j_params = j_model.init(jax.random.PRNGKey(0), jnp.asarray(pix))["params"]
    j_params = j_hf.import_vit_params(j_params, sd)
    bridged = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_params), model)
    for name, value in bridged.items():
        np.testing.assert_allclose(imported[name].detach().numpy(), value.numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)


def test_a_shape_mismatch_is_loud():
    """SaL grows the vocabulary by one context token: a stock checkpoint's
    ``shared.weight`` fails, loudly; ``strict`` raises."""
    sd = numpy_sd(hf_t5(True, "gated-gelu"))
    model = port_t5(True, "gated-gelu", vocab=49)
    params = dict(model.named_parameters())
    report = t_hf.ImportReport()
    out = t_hf.import_t5_params(params, sd, report=report, prefix="")
    failed = dict(report.failed)
    assert "shared.weight" in failed and "shape mismatch" in failed["shared.weight"]
    assert out["shared.weight"] is params["shared.weight"]  # kept, not half written
    with pytest.raises(ValueError, match="shared.weight"):
        t_hf.import_t5_params(params, sd, prefix="", strict=True)


@pytest.mark.parametrize("tied,ffn", [(True, "gated-gelu"), (False, "relu")])
def test_the_report_is_clean_on_a_match(tied, ffn):
    sd = numpy_sd(hf_t5(tied, ffn))
    model = port_t5(tied, ffn)
    report = t_hf.ImportReport()
    t_hf.import_t5_params(dict(model.named_parameters()), sd, report=report, prefix="")
    aliases = {"encoder.embed_tokens.weight", "decoder.embed_tokens.weight"}
    if tied:
        aliases.add("lm_head.weight")
    assert report.failed == [] and report.unused == []
    assert set(report.mapped) == set(sd) - aliases
    standalone = t_hf.import_t5_params(dict(model.named_parameters()), sd, prefix="")
    assert len(standalone) == len(dict(model.named_parameters()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_the_safetensors_reader_round_trips_the_writer(tmp_path, dtype):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "matrix": (torch.randn(5, 7, generator=g) * 3).to(dtype) if dtype != torch.int64
        else torch.randint(-2**40, 2**40, (5, 7), generator=g),
        "scalar": torch.tensor(3, dtype=dtype),
        "empty": torch.zeros(0, 4, dtype=dtype),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = t_hf.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        want = t.float().numpy() if dtype == torch.bfloat16 else t.numpy()
        assert got[name].shape == want.shape and got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want)
    assert set(t_hf._load_state_dict(str(tmp_path))) == set(tensors)


def test_an_unknown_safetensors_dtype_raises(tmp_path):
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header.encode() + b"\x00\x00")
    with pytest.raises(ValueError, match="F8_E4M3"):
        t_hf.read_safetensors(str(path))


def test_pretrained_weights_path_through_the_executor(tmp_path):
    """A ``t5/model.safetensors`` and a ``vit/pytorch_model.bin`` at the tiny
    preset's widths: the port's executor imports them into its masters (in
    train and serve mode, the latter not deferred), as the JAX executor
    does, and parameters no key fills keep their init."""
    paths = make_latr_fixture(tmp_path)
    weights = tmp_path / "weights"
    hf_t5(True, "gated-gelu", vocab_size=512, d_ff=64).save_pretrained(
        str(weights / "t5"), safe_serialization=True)
    hf_vit(num_hidden_layers=2).save_pretrained(str(weights / "vit"), safe_serialization=False)
    assert os.path.isfile(weights / "t5" / "model.safetensors")
    assert os.path.isfile(weights / "vit" / "pytorch_model.bin")
    j_config = get_config(tiny_latr_yaml(paths, str(tmp_path / "ck"),
                                         pretrained_weights_path=str(weights)))
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_cfg = t_config.Config(dict(j_config))
    ex = LaTrExecutor(t_cfg, "train", device="cpu")
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params), ex.model)
    imported = [n for n in want if n.startswith(("t5.", "vit."))]
    assert len(imported) > 40
    for name in imported:
        np.testing.assert_allclose(ex.state.params[name].detach().numpy(), want[name].numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)
    hf_shared = numpy_sd(hf_t5(True, "gated-gelu", vocab_size=512, d_ff=64))["shared.weight"]
    np.testing.assert_array_equal(ex.state.params["t5.shared.weight"].detach().numpy(),
                                  hf_shared)
    fresh = LaTrExecutor(t_config.Config({**t_cfg, "pretrained_weights_path": None}), "train",
                         device="cpu")
    for name in ("visual_projector.weight", "spatial.tables"):  # no key fills these
        torch.testing.assert_close(ex.state.params[name], fresh.state.params[name])
    served = LaTrExecutor(t_cfg, "serve", device="cpu")
    assert not served._abstract_params
    torch.testing.assert_close(served.state.params["t5.shared.weight"],
                               ex.state.params["t5.shared.weight"], atol=0, rtol=0)
