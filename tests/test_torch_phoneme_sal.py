"""The SaL family's training path and decoders in the port against the JAX
package on the CPU, in f32 at tiny widths (the shapes of
``tiny_sal_yaml``), dropout 0: for SaL, CustomizedSaL and PhonemeSaL the
loss and every gradient against ``jax.value_and_grad`` of the JAX
executor's loss, through both routes of the 2D bias (``SAL_FUSED`` on: the
factored form to every layer; off: materialized once per forward), and the
greedy tokens, once with the JAX side through the Pallas SaL kernel in
interpret mode.

Flax initializes the weights and ``models.bridge`` maps them (and the
gradient tree) onto the port's names and layouts.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.models import customized as t_customized
from phoneme_vqa_torch.models import latr as t_latr
from phoneme_vqa_torch.models import phoneme as t_phoneme
from phoneme_vqa_torch.models import sal as t_sal
from phoneme_vqa_torch.models.generate import make_generate_fn as t_make_generate_fn
from phoneme_vqa_torch.ops import attention as t_attn
from phoneme_vqa_torch.ops import sal_fused_attention as t_sfa
from phoneme_vqa_torch.train import optim as t_optim
from phoneme_vqa_torch.train import state as t_state
from phoneme_vqa_tpu.models import customized as j_customized
from phoneme_vqa_tpu.models import phoneme as j_phoneme
from phoneme_vqa_tpu.models import sal as j_sal
from phoneme_vqa_tpu.models.generate import make_generate_fn as j_make_generate_fn
from phoneme_vqa_tpu.ops import attention as j_attn
from phoneme_vqa_tpu.ops import sal_fused_attention as j_sfa
from phoneme_vqa_tpu.train import optim as j_optim

T5_VOCAB, ANSWER_VOCAB = 512, 253  # the flat phoneme vocabulary's size
PAD, BOS, EOS = 0, 1, 2  # the phoneme tokenizer's ids
LQ, LOCR, LOBJ, LA = 8, 12, 8, 10  # tiny_sal_yaml: max_q / ocr / obj / a lengths
CFG = {
    "t5_vocab_size": T5_VOCAB, "d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 64,
    "num_encoder_layers": 2, "num_t5_decoder_layers": 2, "dropout_rate": 0.0,
    "DTYPE": "float32", "ocr_hidden": 16, "obj_hidden": 8, "max_q_length": LQ,
    "max_ocr_length": LOCR, "n_head": 4, "num_decoder_layers": 2,
}
MODELS = ("SaL", "CustomizedSaL", "PhonemeSaL")
# f32 on both sides; gradients bound by their tensor's largest entry, as in
# tests/test_torch_train_latr.py
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-6, 2e-5, 1e-4


def _build(name):
    """(JAX model, port model class, port config, vocabulary of the labels)."""
    if name == "SaL":
        return (j_sal.SaL(j_sal.SaL_config().build(CFG)), t_sal.SaL,
                t_sal.SaL_config().build(CFG), T5_VOCAB)
    j_cfg = j_customized.CustomizedSaL_config().build(CFG, ANSWER_VOCAB, PAD, BOS, EOS)
    t_cfg = t_customized.CustomizedSaL_config().build(CFG, ANSWER_VOCAB, PAD, BOS, EOS)
    j_cls = {"CustomizedSaL": j_customized.CustomizedSaL, "PhonemeSaL": j_phoneme.PhonemeSaL}
    t_cls = {"CustomizedSaL": t_customized.CustomizedSaL, "PhonemeSaL": t_phoneme.PhonemeSaL}
    return j_cls[name](j_cfg), t_cls[name], t_cfg, ANSWER_VOCAB


def _batch(vocab, b=3, seed=0):
    rng = np.random.RandomState(seed)
    ints = lambda hi, *s: rng.randint(3, hi, s).astype(np.int32)
    coords = rng.uniform(0.0, 1.0, (b, LOCR, 4)).astype(np.float32)
    coords[:, -2:] = 0.0  # PAD boxes
    batch = {
        "input_ids": ints(T5_VOCAB, b, LQ), "src_attention_mask": np.ones((b, LQ), np.int32),
        "tokenized_ocr": ints(T5_VOCAB, b, LOCR),
        "ocr_attention_mask": np.ones((b, LOCR), np.int32), "ocr_coordinates": coords,
        "ocr_features": rng.randn(b, LOCR, CFG["ocr_hidden"]).astype(np.float32),
        "tokenized_obj": ints(T5_VOCAB, b, LOBJ),
        "obj_attention_mask": np.ones((b, LOBJ), np.int32),
        "obj_coordinates": rng.uniform(0, 1, (b, LOBJ, 4)).astype(np.float32),
        "obj_features": rng.randn(b, LOBJ, CFG["obj_hidden"]).astype(np.float32),
        "label_ids": ints(vocab, b, LA), "label_attention_mask": np.ones((b, LA), np.int32),
    }
    batch["src_attention_mask"][1:, 5:] = 0
    batch["ocr_attention_mask"][:, -2:] = 0
    batch["obj_attention_mask"][0, 5:] = 0
    batch["label_ids"][0, 6:] = PAD  # a padded answer: its pads are not scored
    batch["label_attention_mask"][0, 6:] = 0
    return batch


def _model_batch(batch):
    return {k: v for k, v in batch.items() if not k.startswith("label")}


@functools.lru_cache(maxsize=None)
def _family(name):
    j_model, t_cls, t_cfg, vocab = _build(name)
    batch = _batch(vocab)
    params = j_model.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in _model_batch(batch).items()},
                          batch["label_ids"][:1, :-1], batch["label_attention_mask"][:1, :-1])
    return name, j_model, t_cls, t_cfg, vocab, jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module", params=MODELS)
def family(request):
    return _family(request.param)


@pytest.fixture(scope="module")
def phoneme_family():
    """PhonemeSaL alone: one family through the Pallas interpreter keeps the
    file fast."""
    return _family("PhonemeSaL")


def _through_pallas(monkeypatch, fn):
    """``fn()`` with the JAX SaL attention through the Pallas kernel in
    interpret mode: both switches set (``SAL_FUSED`` and interpret), the
    kernel calls counted to show it was reached."""
    calls = []
    kernel = j_sfa.sal_fused_attention
    monkeypatch.setattr(j_sfa, "sal_fused_attention",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    saved = (j_attn.SAL_FUSED_ENABLED, j_sfa.INTERPRET)
    j_attn.enable_sal_fused(True)
    j_sfa.set_interpret(True)
    try:
        out = fn()
    finally:
        j_attn.enable_sal_fused(saved[0])
        j_sfa.set_interpret(saved[1])
    assert len(calls) == CFG["num_encoder_layers"]
    return out


@pytest.fixture
def sal_fused():
    """Sets the port's SAL_FUSED knob for one test and restores it."""
    saved = t_attn.sal_fused_enabled()
    yield t_attn.enable_sal_fused
    t_attn.enable_sal_fused(saved)


def _j_loss(model, deterministic):
    """The JAX executor's ``_loss_from_batch``: training mode
    (``deterministic=False``, the bias materialized by ``train_bias``) with a
    dropout key, or the factored bias (``deterministic=True``)."""

    def loss(params, batch):
        logits = model.apply(
            {"params": params}, _model_batch(batch), batch["label_ids"][:, :-1],
            batch["label_attention_mask"][:, :-1], deterministic=deterministic,
            rngs=None if deterministic else {"dropout": jax.random.PRNGKey(1)})
        return j_optim.cross_entropy_loss(logits, batch["label_ids"][:, 1:], PAD)

    return loss


def _port(t_cls, t_cfg, params):
    model = t_cls(t_cfg, device="cpu")
    t_state.bind_params(model, bridge.flax_to_state_dict(params, model))
    return model.train()


def _t_loss(model, batch):
    tb = t_latr.to_device_batch(batch, "cpu", t_sal.BATCH_KEYS)
    labels = torch.from_numpy(batch["label_ids"])
    mask = torch.from_numpy(batch["label_attention_mask"])
    return t_optim.cross_entropy_loss(model(tb, labels[:, :-1], mask[:, :-1]), labels[:, 1:], PAD)


def _check_grads(model, loss, want_loss, want):
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    n_checked = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=name)
        if not np.any(w):  # e.g. relative-bias buckets no distance reaches
            assert not p.grad.any(), name
        n_checked += 1
    assert n_checked == len(want)


@pytest.mark.parametrize("route", ["factored", "materialized"])
def test_loss_and_every_gradient_match_jax_value_and_grad(family, route, sal_fused,
                                                          monkeypatch):
    name, j_model, t_cls, t_cfg, vocab, params = family
    batch = _batch(vocab, seed=1)
    want_loss, j_grads = jax.jit(jax.value_and_grad(_j_loss(j_model, False)))(params, batch)
    model = _port(t_cls, t_cfg, params)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), model)

    sal_fused(route == "factored")
    calls = []
    materialize = t_sfa.materialize_sal_bias
    monkeypatch.setattr(t_sfa, "materialize_sal_bias",
                        lambda *a: calls.append(1) or materialize(*a))
    loss = _t_loss(model, batch)
    loss.backward()
    # off: one materialization a forward; on: every encoder layer gets the
    # factored form (here on the CPU, where the dispatch materializes it)
    assert len(calls) == (CFG["num_encoder_layers"] if route == "factored" else 1)
    _check_grads(model, loss, want_loss, want)
    if name != "SaL":
        assert not hasattr(model.t5, "decoder")


def test_gradients_match_jax_through_the_pallas_sal_kernel(phoneme_family, monkeypatch):
    """The JAX loss with the factored bias through the Pallas kernel
    (interpret mode, ``sal_attention``'s recompute VJP): the port's
    gradients equal it too."""
    name, j_model, t_cls, t_cfg, vocab, params = phoneme_family
    batch = _batch(vocab, seed=2)
    want_loss, j_grads = _through_pallas(
        monkeypatch, lambda: jax.value_and_grad(_j_loss(j_model, True))(params, batch))
    model = _port(t_cls, t_cfg, params)
    loss = _t_loss(model, batch)
    loss.backward()
    _check_grads(model, loss, want_loss,
                 bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_grads), model))


def _greedy(family, want_fn):
    name, j_model, t_cls, t_cfg, vocab, params = family
    batch = _batch(vocab, seed=3)
    ids = {} if name == "SaL" else dict(bos_id=BOS, eos_id=EOS, pad_id=PAD)
    want = want_fn(j_make_generate_fn(j_model, 8, **ids), params, _model_batch(batch))
    model = _port(t_cls, t_cfg, params).eval()
    got = t_make_generate_fn(model, 8)(t_latr.to_device_batch(batch, "cpu", t_sal.BATCH_KEYS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name != "SaL":
        assert model.decode_token_ids == (BOS, EOS, PAD)
        assert (got[:, 0] == BOS).all()


def test_greedy_tokens_identical_to_jax(family):
    _greedy(family, lambda gen, params, batch: jax.jit(gen)(params, batch))


def test_greedy_tokens_identical_to_jax_through_the_pallas_sal_kernel(phoneme_family,
                                                                      monkeypatch):
    # unjitted: the interpreter runs inside
    _greedy(phoneme_family, lambda gen, params, batch: _through_pallas(
        monkeypatch, lambda: gen(params, batch)))


def test_registry_and_configs_match_jax():
    from phoneme_vqa_torch.utils.registry import MODEL_CONFIGS as T_CONFIGS
    from phoneme_vqa_torch.utils.registry import MODELS as T_MODELS

    assert T_MODELS.get("CustomizedSaL") is t_customized.CustomizedSaL
    assert T_MODELS.get("PhonemeSaL") is t_phoneme.PhonemeSaL
    t_cfg = T_CONFIGS.get("CustomizedSaL_config")().build(CFG, 300, 5, 6, 7, 600)
    j_cfg = j_customized.CustomizedSaL_config().build(CFG, 300, 5, 6, 7, 600)
    for field in ("vocab_size", "d_model", "num_heads", "num_layers", "d_ff", "dropout_rate",
                  "max_len", "pad_id", "bos_id", "eos_id"):
        assert getattr(t_cfg.decoder, field) == getattr(j_cfg.decoder, field), field
    assert t_cfg.t5.vocab_size == j_cfg.t5.vocab_size == 600
    assert t_cfg.decoder.dtype == torch.float32


@pytest.mark.parametrize("shape", [(2, 3, 19), (3, 4, 37)])
def test_materialized_bias_gradient_equals_jax(shape):
    """The 2D bias's gradient (the SaL kernel's recompute backward and the
    SAL_FUSED-off route run it): the port's one-hot product equals the JAX
    gather's scatter-add in f32, cell ids past the sentinel included."""
    b, h, l = shape
    rng = np.random.RandomState(l)
    bias1d = rng.randn(h, l, l).astype(np.float32)
    cb = np.zeros((h, 122, 122), np.float32)
    cb[:, :121, :121] = rng.randn(h, 121, 121)
    cell = rng.randint(0, 121, (b, l)).astype(np.int32)
    cell[:, :3] = t_sfa.SENTINEL
    cell[0, 5] = 200
    w = rng.randn(b, h, l, l).astype(np.float32)
    want = jax.grad(lambda b1, c: (j_sfa.materialize_sal_bias(b1, c, cell) * w).sum(),
                    argnums=(0, 1))(bias1d, cb)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (bias1d, cb)]
    out = t_sfa.materialize_sal_bias(*leaves, torch.from_numpy(cell))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=1e-4, rtol=1e-5)
