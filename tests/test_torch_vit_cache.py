"""``VIT_CACHE`` in the port on the CPU at tiny widths in f32: the offline
cache (``phoneme_vqa_torch/data/vit_cache.py``, the executor's
``_maybe_attach_vit_cache``) gives the answers of the uncached run and of the
JAX executor with its own cache, and a train epoch's loss; each validity
rule warns and falls back as the JAX executor does; the serving encoding
cache (``serving/encoding_cache.py``) hits on repeated images in both
engines with unchanged answers, flushes on reload and guards its
generation.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.data.vit_cache import attach_vit_cache
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.serving import ContinuousEngine, ServingEngine
from phoneme_vqa_torch.serving.encoding_cache import EncodingCache
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, make_sal_fixture, tiny_latr_yaml, tiny_sal_yaml


@pytest.fixture(scope="module")
def latr(tmp_path_factory):
    """The JAX and the port's eval-mode LaTr executors with ``VIT_CACHE``,
    the port's holding the JAX one's weights, and the requests."""
    root = tmp_path_factory.mktemp("vit_cache")
    paths = make_latr_fixture(root, n_images=3, n_rows=12)
    j_config = get_config(tiny_latr_yaml(paths, str(root / "ck"), DTYPE="float32",
                                         max_eval_length=10, VIT_CACHE=True))
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="eval")
    params = jax.tree.map(np.asarray, j_ex._ensure_params())
    t_cfg = t_config.Config(dict(j_config))
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", device="cpu")
    t_ex.load_params(bridge.flax_to_state_dict(params, t_ex.model))
    reqs = [(r["image_id"], r["question"]) for r in synthetic.read_qa_csv(paths["val"])]
    return paths, j_config, t_cfg, j_ex, t_ex, params, reqs


def test_cached_eval_answers_equal_the_uncached_and_jax(latr):
    _, _, t_cfg, j_ex, t_ex, params, _ = latr
    plain = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_config.Config({**t_cfg, "VIT_CACHE": False}),
                                            "eval", device="cpu")
    plain.load_params(bridge.flax_to_state_dict(params, plain.model))
    want = plain.infer(plain.val_data, 4, 10)
    t_ex._maybe_attach_vit_cache(("val_data",))
    assert "pixel_values" not in t_ex.val_data.lazy_fields
    assert "vit_encodings" in t_ex.val_data.lazy_fields
    got = t_ex.infer(t_ex.val_data, 4, 10)
    j_ex._maybe_attach_vit_cache(("val_data",))
    assert got == want == j_ex.infer(j_ex.val_data, 4, 10)
    batch = t_ex.val_data.gather(np.arange(4))
    with torch.no_grad():
        encodings = t_ex.model.encode_image(torch.from_numpy(
            plain.val_data.gather(np.arange(4))["pixel_values"]))
    torch.testing.assert_close(batch["vit_encodings"], encodings, atol=0, rtol=0)


def test_attach_dedups_by_image_and_respects_the_cap(latr):
    _, _, t_cfg, _, t_ex, _, _ = latr
    ds = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "eval", device="cpu").val_data
    calls = []

    def encode(pixels):
        calls.append(len(pixels))
        return torch.from_numpy(pixels).flatten(1)[:, :8]

    assert attach_vit_cache(ds, encode, 2, max_bytes=10) == (
        False, "encoding table would be 0.0 GiB for 3 unique images (cap 0.0 GiB; raise "
               "VIT_CACHE_MAX_GB to override)")
    assert "pixel_values" in ds.lazy_fields
    calls.clear()
    ok, reason = attach_vit_cache(ds, encode, 2)
    assert ok and reason.startswith("3 unique images for 6 rows") and calls == [2, 2]
    rows = ds.gather(np.arange(6))["vit_encodings"]
    ids = [str(i) for i in ds.image_ids]
    for i in range(6):
        for j in range(6):
            assert torch.equal(rows[i], rows[j]) == (ids[i] == ids[j])
    assert attach_vit_cache(ds, encode, 2) == (True, "already attached")


def test_a_cached_train_epoch_has_the_uncached_loss(latr, tmp_path):
    paths = latr[0]
    losses = []
    for cache in (False, True):
        cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / str(cache)),
                                                        VIT_CACHE=cache, NUM_EPOCHS=1)))
        ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
        ex._maybe_attach_vit_cache(("train_data", "val_data"))
        assert ("vit_encodings" in ex.train_data.lazy_fields) == cache
        losses.append(ex._train_epoch(1))
    assert losses[0] == losses[1]


def _warned(caplog, text) -> bool:
    return any(text in r.getMessage() for r in caplog.records)


def test_each_validity_rule_warns_and_falls_back(latr, tmp_path, caplog):
    paths = latr[0]
    caplog.set_level(logging.WARNING)
    prestu = dict(EXECUTOR="PreSTU_Executor", MODEL_CLASS="PreSTU",
                  MODEL_MOD_CONFIG_CLASS="PreSTU_config", VIT_CACHE=True)
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / "p"), **prestu)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    ex._maybe_attach_vit_cache(("train_data", "val_data"))
    assert "pixel_values" in ex.train_data.lazy_fields and "pixel_values" in ex.val_data.lazy_fields
    assert _warned(caplog, "VIT_CACHE ignored in train mode: PreSTU trains its ViT")
    ev = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")  # static weights: cached
    ev._maybe_attach_vit_cache(("val_data",))
    assert "vit_encodings" in ev.val_data.lazy_fields

    lora = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / "l"), VIT_CACHE=True,
                                                     LORA_RANK=2, LORA_TARGETS="query,q")))
    ex = T_EXECUTORS.get(lora.EXECUTOR)(lora, "train", device="cpu")
    ex._maybe_attach_vit_cache(("train_data",))
    assert "pixel_values" in ex.train_data.lazy_fields
    assert _warned(caplog, "VIT_CACHE ignored: LoRA adapters target the ViT")
    only_t5 = t_config.Config({**lora, "LORA_TARGETS": "q"})
    ex = T_EXECUTORS.get(only_t5.EXECUTOR)(only_t5, "train", device="cpu")
    ex._maybe_attach_vit_cache(("train_data",))
    assert "vit_encodings" in ex.train_data.lazy_fields

    sal_paths = make_sal_fixture(tmp_path / "sal")
    sal = t_config.Config(get_config(tiny_sal_yaml(sal_paths, str(tmp_path / "s"),
                                                   VIT_CACHE=True)))
    ex = T_EXECUTORS.get(sal.EXECUTOR)(sal, "eval", device="cpu")
    ex._maybe_attach_vit_cache(("val_data",))
    assert _warned(caplog, "VIT_CACHE ignored: SaL has no image encoder")
    assert EncodingCache.maybe_build(ex) is None


def test_the_gathered_engine_hits_and_answers_as_uncached(latr):
    _, _, _, _, t_ex, _, reqs = latr
    plain = t_ex.infer(T_EXECUTORS.get(t_ex.config.EXECUTOR)(t_ex.config, "eval", device="cpu")
                       .val_data, 4, 10)
    with ServingEngine(t_ex, *t_ex.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as eng:
        assert eng._enc_cache is not None
        rounds = [[f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
                  for _ in range(2)]
        stats = eng.stats()["vit_cache"]
    assert rounds[0] == rounds[1] == plain
    n_images = len({str(i) for i, _ in reqs})
    assert stats["entries"] == stats["misses"] == n_images
    assert stats["hits"] == 2 * len(reqs) - n_images + 1  # +1: the warmup row repeats
    assert stats["bytes"] > 0


def test_the_continuous_engine_hits_and_answers_as_uncached(latr):
    _, _, _, _, t_ex, _, reqs = latr
    plain = t_ex.infer(T_EXECUTORS.get(t_ex.config.EXECUTOR)(t_ex.config, "eval", device="cpu")
                       .val_data, 4, 10)
    with ContinuousEngine(t_ex, *t_ex.serve_frames, num_slots=4, prefill_chunk=2, horizon=4,
                          max_answer_length=10) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
        stats = eng.stats()["vit_cache"]
    assert got == plain
    assert stats["hits"] > 0 and stats["entries"] == len({str(i) for i, _ in reqs})


def test_flush_on_reload_and_the_generation_guard(latr, tmp_path):
    _, _, t_cfg, _, t_ex, _, reqs = latr
    cfg = t_config.Config({**t_cfg, "SAVE_PATH": str(tmp_path)})
    trainer = T_EXECUTORS.get(cfg.EXECUTOR)(t_config.Config({**cfg, "VIT_CACHE": False}),
                                            "train", device="cpu")
    served = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    trainer.load_params({n: p.detach().clone() for n, p in t_ex.state.params.items()})
    trainer._save_checkpoint("best")
    served._load_trained_checkpoint("best")
    with ServingEngine(served, *served.serve_frames, batch_size=4, max_wait_ms=20,
                       max_answer_length=10) as eng:
        [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
        assert eng.stats()["vit_cache"]["entries"] > 0
        gen = eng._enc_cache.generation
        g = torch.Generator().manual_seed(3)
        trainer.load_params({n: torch.randn(p.shape, generator=g) * 0.5
                             for n, p in trainer.state.params.items()})
        trainer._save_checkpoint("best")
        eng.reload("best")
        assert eng._enc_cache.generation == gen + 1
        assert eng.stats()["vit_cache"]["entries"] == 0
        after = [f.result(timeout=120) for f in [eng.submit(i, q) for i, q in reqs]]
    fresh = T_EXECUTORS.get(cfg.EXECUTOR)(t_config.Config({**cfg, "VIT_CACHE": False}), "eval",
                                          device="cpu")
    fresh._load_trained_checkpoint("best")
    assert after == fresh.infer(fresh.val_data, 4, 10)

    # an encode that a flush overtakes serves its own batch and inserts nothing
    cache = EncodingCache(served, chunk=2)
    ds = served._make_dataset([{"image_id": i, "question": q, "answer": ""} for i, q in reqs],
                              served.serve_frames[0])
    real = cache._encode_missing

    def flushed_meanwhile(*a):
        out = real(*a)
        cache.flush()
        return out

    cache._encode_missing = flushed_meanwhile
    cache.apply(ds, [i for i, _ in reqs])
    assert ds.arrays["vit_encodings"].shape[0] == len(reqs)
    assert cache.stats()["entries"] == 0 and cache.generation == 1
