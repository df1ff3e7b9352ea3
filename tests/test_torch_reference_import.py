"""The port's reference-checkpoint import
(``phoneme_vqa_torch/models/hf_import.py: import_reference_state_dict``) and
converter (``python -m phoneme_vqa_torch.import_reference_ckpt``) on the CPU
at tiny widths in f32. The reference state dicts are built here, in the
reference's key layout, from modules of their own (HF T5 / T5 encoder and
ViT, torch ``nn.TransformerDecoder``, Linear and Embedding tables) with
seeded values: a LaTr, a CustomizedSaL and a PhonemeSaL tree. The port's
import equals the JAX package's (bridged) within 1e-6; the converter's
checkpoint evaluates to the in-process import's answers and to the JAX
executor's on the JAX import; the unsafe load is gated; a params-only resume
keeps step and epoch with a fresh optimizer.
"""

import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import import_reference_ckpt as converter
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import hf_import as t_hf
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.models import hf_import as j_hf
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, make_sal_fixture, tiny_latr_yaml, tiny_sal_yaml

transformers = pytest.importorskip("transformers")

JAX_TOL = 1e-6
CUSTOM = dict(n_head=4, num_decoder_layers=2, MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config")
FAMILIES = {
    "latr": None,
    "customized_sal": dict(CUSTOM, EXECUTOR="CustomizedSaL_Executor", MODEL_CLASS="CustomizedSaL",
                           DecodeTokenizer="CharTokenizer"),
    "phoneme_sal": dict(CUSTOM, EXECUTOR="PhonemeSaL_Executor", MODEL_CLASS="PhonemeSaL",
                        max_a_length=24, max_eval_length=24, max_predict_length=24),
}


def _randomize(module: nn.Module, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) * 0.3).numpy()
            for k, v in module.state_dict().items()}


def reference_state_dict(t_ex, seed: int = 0) -> dict:
    """A reference model's ``state_dict()`` for the executor's family, with
    the shapes its parameters imply and seeded values."""
    from transformers import T5Config, T5EncoderModel, T5ForConditionalGeneration, ViTConfig, \
        ViTModel

    shapes = {n: tuple(p.shape) for n, p in t_ex.model.named_parameters()}
    vocab, d = shapes["t5.shared.weight"]
    n_enc = len({n.split(".")[2] for n in shapes if n.startswith("t5.encoder.block_")})
    d_ff, heads = shapes["t5.encoder.block_0.ffn.wo.weight"][1], \
        shapes["t5.encoder.block_0.attn.q.weight"][0] // 8
    sd = {}
    if "t5.decoder.final_ln.weight" in shapes:  # LaTr: the stock HF T5 as "backbone"
        t5_cfg = T5Config(vocab_size=vocab, d_model=d, d_kv=8, num_heads=heads, d_ff=d_ff,
                          num_layers=n_enc, num_decoder_layers=n_enc,
                          feed_forward_proj="gated-gelu", tie_word_embeddings=True)
        t5 = _randomize(T5ForConditionalGeneration(t5_cfg), seed)
        sd.update({f"backbone.{k}": v for k, v in t5.items()})
    else:  # the customized / phoneme families: an encoder-only T5 as "encoder"
        t5_cfg = T5Config(vocab_size=vocab, d_model=d, d_kv=8, num_heads=heads, d_ff=d_ff,
                          num_layers=n_enc, feed_forward_proj="gated-gelu")
        sd.update({f"encoder.{k}": v
                   for k, v in _randomize(T5EncoderModel(t5_cfg), seed).items()})
    if "vit.cls_token" in shapes:
        hidden = shapes["vit.cls_token"][-1]
        vit_cfg = ViTConfig(image_size=32, patch_size=16, hidden_size=hidden,
                            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64)
        sd.update({f"vit.{k}": v for k, v in
                   _randomize(ViTModel(vit_cfg, add_pooling_layer=False), seed + 1).items()})
        sd.update({f"visual_projector.{k}": v for k, v in
                   _randomize(nn.Linear(hidden, d), seed + 2).items()})
        for i, name in enumerate(("top_left_x", "top_left_y", "bottom_right_x", "bottom_right_y",
                                  "width_emb", "height_emb")):
            sd[f"spatial_feat_extractor.{name}.weight"] = _randomize(
                nn.Embedding(shapes["spatial.tables"][1], d), seed + 10 + i)["weight"]
    if "rel2d.rel1d.weight" in shapes:  # SaL: the 2-D bias, the feature streams
        for key, name in (("Relative1D", "rel2d.rel1d.weight"), ("SCP", "rel2d.scp.weight")):
            sd[f"rel2Dbias.{key}.relative_attention_bias.weight"] = _randomize(
                nn.Embedding(*shapes[name]), seed + 20 + len(sd))["weight"]
        for stream in ("ocr", "obj"):
            for mod in ("feature_projector", "bbox_projector"):
                out_dim, in_dim = shapes[f"{stream}_{mod}.weight"]
                sd.update({f"{stream}_{mod}.{k}": v for k, v in
                           _randomize(nn.Linear(in_dim, out_dim), seed + len(sd)).items()})
            sd[f"{stream}_feature_layer_norm.weight"] = np.random.RandomState(
                seed + len(sd)).randn(d).astype(np.float32)
    if "decoder.embed.weight" in shapes:  # the custom decoder: torch layers
        n_dec = len({n.split(".")[1] for n in shapes if n.startswith("decoder.layer_")})
        dim_ff = shapes["decoder.layer_0.fc1.weight"][0]
        layers = nn.TransformerDecoder(nn.TransformerDecoderLayer(d, 4, dim_ff), n_dec)
        sd.update({f"decoder.decoder.{k}": v for k, v in _randomize(layers, seed + 30).items()})
        tgt_vocab = shapes["decoder.embed.weight"][0]
        table = _randomize(nn.Embedding(tgt_vocab, d), seed + 31)["weight"]
        if t_ex.config.MODEL_CLASS == "PhonemeSaL":  # a plain nn.Embedding
            sd["tgt_tok_emb.weight"] = table
        else:  # the sqrt(d)-scaled TokenEmbedding module
            sd["tgt_tok_emb.embedding.weight"] = table
        sd.update({f"lm_head.{k}": v for k, v in
                   _randomize(nn.Linear(d, tgt_vocab), seed + 32).items()})
    return sd


def _configs(root, family, **over):
    if family == "latr":
        paths = make_latr_fixture(root)
        j_config = get_config(tiny_latr_yaml(paths, str(root / "jax"), **over))
    else:
        paths = make_sal_fixture(root)
        j_config = get_config(tiny_sal_yaml(paths, str(root / "jax"),
                                            **{**FAMILIES[family], **over}))
    return j_config, t_config.Config({**j_config, "SAVE_PATH": str(root / "port")})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_reference_state_dict_matches_the_jax_import(tmp_path, family):
    j_config, t_cfg = _configs(tmp_path, family)
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    initial = jax.tree.map(np.asarray, j_ex.state.params)
    t_ex.load_params(bridge.flax_to_state_dict(initial, t_ex.model))
    sd = reference_state_dict(t_ex)

    j_report, t_report = j_hf.ImportReport(), t_hf.ImportReport()
    want = bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, j_hf.import_reference_state_dict(initial, sd, j_report)),
        t_ex.model)
    got = t_hf.import_reference_state_dict(t_ex.state.params, sd, t_report)
    assert t_report.failed == [] and j_report.failed == []
    # (the JAX ViT import names its own paths in the report, not the keys)
    assert len(t_report.mapped) == len(j_report.mapped)
    assert t_report.unused == []
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=name)
    moved = [n for n in got if got[n] is not t_ex.state.params[n]]
    assert len(moved) == len(got), sorted(set(got) - set(moved))  # the tree fills every one
    if family == "phoneme_sal":  # weight / sqrt(d) into the sqrt(d)-scaled embedding
        table = sd["tgt_tok_emb.weight"]
        np.testing.assert_allclose(got["decoder.embed.weight"].numpy(),
                                   table / np.sqrt(table.shape[1]), rtol=1e-6)


def test_an_unmappable_tensor_is_reported(tmp_path):
    params = {"visual_projector.weight": torch.zeros(8, 4), "visual_projector.bias": torch.zeros(8)}
    report = t_hf.ImportReport()
    out = t_hf.import_reference_state_dict(params, {"visual_projector.weight": np.ones((8, 4)),
                                                    "visual_projector.bias": np.ones(9)}, report)
    assert report.mapped == ["visual_projector.weight"]
    assert [k for k, _ in report.failed] == ["visual_projector.bias"]
    assert float(out["visual_projector.weight"].sum()) == 32.0
    assert out["visual_projector.bias"] is params["visual_projector.bias"]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A LaTr reference .pth, converted by the CLI into the port's best_ckp."""
    root = tmp_path_factory.mktemp("convert")
    j_config, t_cfg = _configs(root, "latr", DTYPE="float32", max_eval_length=8)
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", device="cpu")
    t_ex._ensure_params()
    sd = reference_state_dict(t_ex, seed=7)
    pth = str(root / "best_ckp.pth")
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in sd.items()}, "epoch": 3,
                "step": 9, "best_score": 0.5}, pth)
    import yaml

    yaml_path = str(root / "port.yaml")
    with open(yaml_path, "w", encoding="utf-8") as f:
        yaml.safe_dump(dict(t_cfg), f)
    report = converter.main(["--config-file", yaml_path, "--ckpt", pth, "--name", "best",
                             "--device", "cpu"])
    return root, j_config, t_cfg, sd, report, pth, yaml_path


def test_the_converted_checkpoint_answers_as_the_in_process_import(converted):
    root, j_config, t_cfg, sd, report, _, _ = converted
    assert report.failed == [] and len(report.mapped) > 80
    assert os.path.isfile(os.path.join(t_cfg.SAVE_PATH, "best_ckp"))
    ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", evaltype="best", device="cpu")
    ex._load_trained_checkpoint("best")
    got = ex.infer(ex.val_data, 4, 8)

    ref = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", device="cpu")
    ref.load_params(t_hf.import_reference_state_dict(ref._ensure_params(), sd))
    assert got == ref.infer(ref.val_data, 4, 8)

    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval")
    j_params = j_hf.import_reference_state_dict(jax.tree.map(np.asarray, j_ex._ensure_params()),
                                                sd)
    j_ex.state = j_ex.state.replace(params=j_params)
    j_ex._bf16_params_cache = None
    assert got == j_ex.infer(j_ex.val_data, 4, 8)
    saved = torch.load(os.path.join(t_cfg.SAVE_PATH, "best_ckp"), weights_only=True)
    assert (saved["step"], saved["epoch"], saved["best_score"]) == (9, 3, 0.5)
    assert "opt_state" not in saved


def test_a_params_only_checkpoint_resumes_with_a_fresh_optimizer(converted):
    root, _, t_cfg, _, _, _, _ = converted
    saved = torch.load(os.path.join(t_cfg.SAVE_PATH, "best_ckp"), weights_only=True)
    cfg = t_config.Config({**t_cfg, "NUM_EPOCHS": 4})
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    assert (ex.state.step, ex.state.epoch, ex.best_score) == (9, 3, 0.5)
    assert ex.state.opt_state["count"] == 0
    for name, value in saved["params"].items():
        torch.testing.assert_close(ex.state.params[name], value, atol=0, rtol=0)
    ex.run()  # epoch 4 only
    last = torch.load(os.path.join(t_cfg.SAVE_PATH, "last_ckp"), weights_only=True)
    assert last["epoch"] == 4 and last["opt_state"]["count"] == 1


class _NotATensor:
    pass


def test_the_unsafe_load_is_gated(tmp_path, monkeypatch):
    module = types.ModuleType("_port_ckpt_test_helper")
    _NotATensor.__module__ = module.__name__
    module._NotATensor = _NotATensor
    monkeypatch.setitem(__import__("sys").modules, module.__name__, module)
    path = str(tmp_path / "odd.pth")
    with open(path, "wb") as f:
        torch.save({"state_dict": {}, "extra": _NotATensor()}, f, pickle_module=pickle)
    with pytest.raises(SystemExit, match="--unsafe-load"):
        converter.load_reference_ckpt(path)
    assert isinstance(converter.load_reference_ckpt(path, unsafe=True)["extra"], _NotATensor)


def test_the_converter_refuses_a_partial_import(converted, tmp_path):
    root, _, t_cfg, sd, _, _, yaml_path = converted
    broken = dict(sd, **{"visual_projector.bias": np.zeros(5, np.float32)})
    pth = str(tmp_path / "broken.pth")
    torch.save({k: torch.tensor(v) for k, v in broken.items()}, pth)
    with pytest.raises(ValueError, match="visual_projector.bias"):
        converter.main(["--config-file", yaml_path, "--ckpt", pth, "--name", "last",
                        "--device", "cpu"])
    report = converter.main(["--config-file", yaml_path, "--ckpt", pth, "--name", "last",
                             "--device", "cpu", "--allow-partial"])
    assert [k for k, _ in report.failed] == ["visual_projector.bias"]
