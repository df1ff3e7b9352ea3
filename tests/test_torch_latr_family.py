"""The LaTr and PreSTU families' customized and phoneme models in the port
against the JAX package on the CPU, in f32 at tiny widths (``d_model`` 40,
not divisible by 3; 2 encoder and decoder layers; 4 heads), dropout 0:
for PhonemeLaTr, CustomizedLaTr, PreSTU, CustomizedPreSTU and PhonemePreSTU
the loss and every gradient against ``jax.value_and_grad`` of the JAX
executor's loss (PreSTU's ViT gradients included; the frozen ViTs take
none), the greedy tokens or (onset, rhyme, tone) triples, the registries
and configs; and one bf16 PhonemeLaTr forward and loss.

Flax initializes the weights and ``models.bridge`` maps them (and the
gradient tree) onto the port's names and layouts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import prestu as t_prestu
from phoneme_vqa_torch.models.generate import build_generate_fn
from phoneme_vqa_torch.train import optim as t_optim
from phoneme_vqa_torch.train import state as t_state
from phoneme_vqa_torch.utils.registry import MODEL_CONFIGS as T_CONFIGS
from phoneme_vqa_torch.utils.registry import MODELS as T_MODELS
from phoneme_vqa_tpu.models import customized as j_customized
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.models import prestu as j_prestu
from phoneme_vqa_tpu.models.generate import make_generate_fn as j_make_generate_fn
from phoneme_vqa_tpu.models.generate import make_multi_head_generate_fn
from phoneme_vqa_tpu.train import optim as j_optim

T5_VOCAB, ANSWER_VOCAB = 256, 60
ANSWER_IDS = dict(pad_id=0, bos_id=1, eos_id=2)  # a char tokenizer's
PHONEME_VOCABS = dict(onset_vocab=30, rhyme_vocab=50, tone_vocab=8)
PHONEME_IDS = dict(pad_id=2, bos_id=3, eos_id=4)  # the structured tokenizer's
LQ, LOCR, LA, LPRESTU = 8, 12, 10, 20  # question, OCR, answer, PreSTU question + OCR
CFG = {
    "t5_vocab_size": T5_VOCAB, "d_model": 40, "d_kv": 8, "num_heads": 4, "d_ff": 64,
    "num_encoder_layers": 2, "num_t5_decoder_layers": 2, "dropout_rate": 0.0,
    "vit_image_size": 32, "vit_patch_size": 16, "vit_hidden_size": 32, "vit_num_layers": 2,
    "vit_num_heads": 4, "vit_mlp_dim": 64, "DTYPE": "float32",
    "max_2d_position_embeddings": 1024, "n_head": 4, "num_decoder_layers": 2,
}
MODELS = ("PhonemeLaTr", "CustomizedLaTr", "PreSTU", "CustomizedPreSTU", "PhonemePreSTU")
# f32 on both sides; gradients bound by their tensor's largest entry, as in
# tests/test_torch_train_latr.py
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-6, 2e-5, 1e-4
# bf16: both frameworks round the same f32 weights to bf16, but sum in
# another order and round intermediates at other places
BF16_LOSS_RTOL = 2e-2


def _phoneme_cfg(mod, base, config):
    return mod.PhonemeLaTrConfig(
        t5=base.t5, vit=base.vit, max_2d_position_embeddings=base.max_2d_position_embeddings,
        freeze_vit=True, phoneme_decoder=mod.phoneme_decoder_from_yaml(
            config, base.t5, **PHONEME_VOCABS, **PHONEME_IDS))


def _configs(name, config=CFG):
    """(JAX config, port config), as the executors build them."""
    if name == "PreSTU":
        return j_prestu.PreSTU_config().build(config), t_prestu.PreSTU_config().build(config)
    base = "LaTr" if "LaTr" in name else "PreSTU"
    j_builder = getattr(j_customized, f"Customized{base}_config")()
    t_builder = T_CONFIGS.get(f"Customized{base}_config")()
    if name.startswith("Customized"):
        args = (ANSWER_VOCAB, *ANSWER_IDS.values())
        return j_builder.build(config, *args), t_builder.build(config, *args)
    return (_phoneme_cfg(j_phoneme, j_builder.build(config), config),
            _phoneme_cfg(t_phoneme, t_builder.build(config), config))


def _j_model(name, cfg):
    mod = {"PreSTU": j_prestu}.get(name, j_phoneme if name.startswith("Phoneme")
                                   else j_customized)
    return getattr(mod, name)(cfg)


def _batch(name, b=3, seed=0):
    rng = np.random.RandomState(seed)
    ints = lambda hi, *s: rng.randint(5, hi, s).astype(np.int32)
    prestu = "PreSTU" in name
    lq = LPRESTU if prestu else LQ
    batch = {
        "pixel_values": rng.randn(b, 3, 32, 32).astype(np.float32),
        "input_ids": ints(T5_VOCAB, b, lq), "src_attention_mask": np.ones((b, lq), np.int32),
        "label_attention_mask": np.ones((b, LA), np.int32),
    }
    batch["src_attention_mask"][1:, lq - 3:] = 0
    if not prestu:
        batch.update(tokenized_ocr=ints(T5_VOCAB, b, LOCR),
                     ocr_attention_mask=np.ones((b, LOCR), np.int32),
                     coordinates=rng.randint(0, 1000, (b, LOCR, 6)).astype(np.int32))
        batch["ocr_attention_mask"][:, 9:] = 0
    if name.startswith("Phoneme"):
        labels = np.stack([ints(v, b, LA) for v in PHONEME_VOCABS.values()], -1)
        labels[:, 0] = PHONEME_IDS["bos_id"]
        labels[0, 6:] = PHONEME_IDS["pad_id"]  # a padded answer: its pads are not scored
        labels[1, 4, 1:] = PHONEME_IDS["pad_id"]  # a pad in rhyme and tone only
        batch["label_attention_mask"] = (labels[..., 0] != PHONEME_IDS["pad_id"]).astype(np.int32)
    else:
        vocab, pad = (T5_VOCAB, 0) if name == "PreSTU" else (ANSWER_VOCAB, ANSWER_IDS["pad_id"])
        labels = ints(vocab, b, LA)
        labels[0, 6:] = pad
        batch["label_attention_mask"][0, 6:] = 0
    batch["label_ids"] = labels
    return batch


def _model_batch(batch):
    return {k: v for k, v in batch.items() if not k.startswith("label")}


def _pad(name):
    if name.startswith("Phoneme"):
        return PHONEME_IDS["pad_id"]
    return 0 if name == "PreSTU" else ANSWER_IDS["pad_id"]


@functools.lru_cache(maxsize=None)
def _family(name, dtype="float32"):
    config = dict(CFG, DTYPE=dtype)
    j_cfg, t_cfg = _configs(name, config)
    j_model = _j_model(name, j_cfg)
    batch = _batch(name)
    params = jax.jit(j_model.init)(
        jax.random.PRNGKey(0), {k: v[:1] for k, v in _model_batch(batch).items()},
        batch["label_ids"][:1, :-1], batch["label_attention_mask"][:1, :-1])
    return name, j_model, t_cfg, jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module", params=MODELS)
def family(request):
    return _family(request.param)


def _j_loss(name, model):
    """The JAX executors' ``_loss_from_batch`` (no dropout): one CE over the
    answer ids, or the sum of the onset, rhyme and tone CEs."""
    pad = _pad(name)

    def loss(params, batch):
        labels = batch["label_ids"]
        out = model.apply({"params": params}, _model_batch(batch), labels[:, :-1],
                          batch["label_attention_mask"][:, :-1])
        if name.startswith("Phoneme"):
            return sum(j_optim.cross_entropy_loss(l, labels[:, 1:, c], pad)
                       for c, l in enumerate(out))
        return j_optim.cross_entropy_loss(out, labels[:, 1:], pad)

    return loss


def _port(name, t_cfg, params):
    model = T_MODELS.get(name)(t_cfg, device="cpu")
    t_state.bind_params(model, bridge.flax_to_state_dict(params, model))
    return model.train()


def _t_loss(name, model, batch):
    tb = t_latr.to_device_batch(batch, "cpu", model.BATCH_KEYS)
    labels = torch.from_numpy(batch["label_ids"])
    mask = torch.from_numpy(batch["label_attention_mask"])
    out = model(tb, labels[:, :-1], mask[:, :-1])
    pad = _pad(name)
    if name.startswith("Phoneme"):
        return sum(t_optim.cross_entropy_loss(l, labels[:, 1:, c], pad)
                   for c, l in enumerate(out)), out
    return t_optim.cross_entropy_loss(out, labels[:, 1:], pad), out


def test_loss_and_every_gradient_match_jax_value_and_grad(family):
    name, j_model, t_cfg, params = family
    batch = _batch(name, seed=1)
    want_loss, j_grads = jax.jit(jax.value_and_grad(_j_loss(name, j_model)))(params, batch)
    model = _port(name, t_cfg, params)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), model)
    loss, _ = _t_loss(name, model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    frozen = name != "PreSTU"  # PreSTU_config trains its ViT; every other model freezes it
    n_checked = n_vit = 0
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        if pname.startswith("vit."):
            n_vit += 1
            if frozen:  # stop_gradient in flax, no_grad here
                assert p.grad is None and not np.any(w), pname
                continue
            assert np.abs(w).max() > 0, pname  # the ViT really trains
        assert p.grad is not None, pname
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=pname)
        if not np.any(w):  # e.g. relative-bias buckets no distance reaches
            assert not p.grad.any(), pname
        n_checked += 1
    assert n_vit > 10 and n_checked > 40
    assert n_checked + (n_vit if frozen else 0) == len(want)
    if name != "PreSTU":  # the encoder-only backbone
        assert not hasattr(model.t5, "decoder")
    assert hasattr(model, "spatial") == ("LaTr" in name)


def test_greedy_tokens_or_triples_identical_to_jax(family):
    name, j_model, t_cfg, params = family
    batch = _batch(name, seed=3)
    if name.startswith("Phoneme"):
        gen = make_multi_head_generate_fn(j_model, 8, 3, PHONEME_IDS["bos_id"],
                                          PHONEME_IDS["eos_id"], PHONEME_IDS["pad_id"])
        ids = PHONEME_IDS
    else:
        ids = {} if name == "PreSTU" else ANSWER_IDS
        gen = j_make_generate_fn(j_model, 8, **ids)
    want = np.asarray(jax.jit(gen)(params, _model_batch(batch)))
    model = _port(name, t_cfg, params).eval()
    got = build_generate_fn(model, 8)(t_latr.to_device_batch(batch, "cpu", model.BATCH_KEYS))
    assert got.shape == want.shape == ((3, 8, 3) if name.startswith("Phoneme") else (3, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    if ids:
        assert model.decode_token_ids == (ids["bos_id"], ids["eos_id"], ids["pad_id"])


def test_registries_and_configs_match_jax():
    from phoneme_vqa_tpu import registry_setup  # noqa: F401
    from phoneme_vqa_tpu.utils.registry import MODEL_CONFIGS as J_CONFIGS
    from phoneme_vqa_tpu.utils.registry import MODELS as J_MODELS

    for name in MODELS:
        assert T_MODELS.get(name).__name__ == J_MODELS.get(name).__name__ == name
    for name in ("PreSTU_config", "CustomizedLaTr_config", "CustomizedPreSTU_config"):
        assert T_CONFIGS.get(name).__name__ == J_CONFIGS.get(name).__name__ == name
    for name in MODELS:
        j_cfg, t_cfg = _configs(name)
        assert t_cfg.freeze_vit == j_cfg.freeze_vit == (name != "PreSTU"), name
        assert t_cfg.max_2d_position_embeddings == j_cfg.max_2d_position_embeddings, name
        for field in ("vocab_size", "d_model", "num_heads", "d_kv", "d_ff", "num_layers"):
            assert getattr(t_cfg.t5, field) == getattr(j_cfg.t5, field), (name, field)
        dec = "phoneme_decoder" if name.startswith("Phoneme") else \
            "decoder" if name.startswith("Customized") else None
        if dec:
            t_dec, j_dec = getattr(t_cfg, dec), getattr(j_cfg, dec)
            for field in dataclass_fields(t_dec):
                if field != "dtype":
                    assert getattr(t_dec, field) == getattr(j_dec, field), (name, field)
            assert t_dec.dtype == torch.float32
    # the customized LaTr and PreSTU builders take no backbone vocabulary size
    with pytest.raises(TypeError):
        T_CONFIGS.get("CustomizedLaTr_config")().build(CFG, new_token_embedding_size=600)


def dataclass_fields(obj):
    import dataclasses

    return [f.name for f in dataclasses.fields(obj)]


def test_bf16_phoneme_latr_forward_and_loss_hold_against_jax():
    """bf16 compute on both sides from the same f32 weights: the loss
    within 2e-2 relative; each head's argmax equal wherever JAX's top-2
    logits part by more than the logits' gap (the rest are bf16 ties)."""
    name, j_model, t_cfg, params = _family("PhonemeLaTr", "bfloat16")
    assert t_cfg.t5.dtype == t_cfg.phoneme_decoder.dtype == torch.bfloat16
    batch = _batch(name, seed=4)
    labels = batch["label_ids"]
    want_loss = float(jax.jit(_j_loss(name, j_model))(params, batch))
    want = jax.jit(j_model.apply)({"params": params}, _model_batch(batch), labels[:, :-1],
                                  batch["label_attention_mask"][:, :-1])
    model = _port(name, t_cfg, params).eval()
    with torch.no_grad():
        loss, got = _t_loss(name, model, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=BF16_LOSS_RTOL)
    n_compared = 0
    for c, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.dtype == np.float32 and np.isfinite(g).all()
        gap = float(np.abs(g - w).max())
        top2 = np.sort(w, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > gap
        assert clear.mean() > 0.5, c
        np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear], err_msg=str(c))
        n_compared += int(clear.sum())
    assert n_compared > 0
    assert jnp.asarray(want[0]).dtype == jnp.float32  # the heads' logits are cast to f32
