"""LoRA in the port (``phoneme_vqa_torch/train/lora.py``, the executor's
LoRA step, serving adapters) against the JAX package, on the CPU at tiny
widths in f32: at init the merged model's logits equal the base's;
``merge_lora`` equals JAX's; three LoRA steps from the same bridged base and
adapters match the JAX executor's (optax ``multi_transform``) within 1e-5
(but at elements whose gradient sat at rounding level, which adam's
normalized step parts by up to 2 lr; under 0.1 % of them), with optimizer
state for the adapters only and the base bit for bit
unchanged; the ``{base, lora}`` checkpoint round-trips and evaluates without
``LORA_*`` keys as the JAX executor answers; LoRA and flat checkpoints
resume across layouts; two serving adapters answer as engines over their
merged weights, switching back restores the base bit for bit, an unknown
adapter raises ``KeyError`` and the continuous engine refuses adapters.
"""

import os

import jax
import numpy as np
import pytest
import torch

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import serve as t_serve
from phoneme_vqa_torch.data import synthetic
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.serving import ContinuousEngine, ServingEngine
from phoneme_vqa_torch.train import lora as t_lora
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import Config as JaxConfig
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.train import lora as j_lora
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, tiny_latr_yaml

TOL = 1e-5
STEPS = 3
LORA = dict(LORA_RANK=4, LORA_ALPHA=8)


def _adapters(tree) -> dict:
    return bridge.flax_lora_to_adapters(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX and the port's LaTr executors with LoRA (rank 4), the port's
    from the JAX one's base and adapters, each trained three one-step
    epochs on the same shuffles."""
    root = tmp_path_factory.mktemp("lora")
    paths = make_latr_fixture(root)
    j_config = get_config(tiny_latr_yaml(paths, str(root / "jax"), NUM_EPOCHS=STEPS, **LORA))
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": str(root / "port")})
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    j_params = jax.tree.map(np.asarray, j_ex.state.params)
    t_ex.load_params(bridge.flax_to_state_dict(j_params["base"], t_ex.model),
                     lora=_adapters(j_params["lora"]))
    start = {n: p.detach().clone() for n, p in t_ex.state.params.items()}
    j_losses, t_losses = [], []
    for epoch in range(1, STEPS + 1):
        j_losses.append(j_ex._train_epoch(epoch))
        t_losses.append(t_ex._train_epoch(epoch))
    return paths, j_config, t_cfg, j_ex, t_ex, j_params, start, j_losses, t_losses


def test_at_init_the_logits_equal_the_base(tmp_path):
    paths = make_latr_fixture(tmp_path)
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / "ck"), **LORA)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    base = T_EXECUTORS.get(cfg.EXECUTOR)(t_config.Config({**cfg, "LORA_RANK": 0}), "train",
                                         device="cpu")
    base.load_params({n: t.detach().clone() for n, t in ex.state.params.items()})
    assert all(float(ad["a"].detach().abs().sum()) > 0 and not ad["b"].any()
               for ad in ex.state.lora.values())
    batch = ex._to_device(ex.train_data.gather(np.arange(8)))
    with torch.no_grad():
        got = ex.forward_loss(batch)
        want = base.forward_loss(batch)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    ex._uninstall_lora()
    for name, p in ex.model.named_parameters():
        torch.testing.assert_close(p, base.model.get_parameter(name), atol=0, rtol=0)


def test_lora_targets_and_the_zero_match_error(tmp_path):
    paths = make_latr_fixture(tmp_path)
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(tmp_path / "ck"))))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    g = torch.Generator().manual_seed(0)
    attn = t_lora.init_lora(ex.model, t_lora.from_config(cfg | {"LORA_RANK": 2}), g)
    every = t_lora.init_lora(ex.model, t_lora.from_config(cfg | {"LORA_RANK": 2,
                                                                  "LORA_TARGETS": "all"}), g)
    assert all(n.rsplit(".", 2)[-2] in t_lora.ATTN_MODULES for n in attn)
    assert set(attn) < set(every) and any(".ffn.wo." in n for n in every)
    assert not any("visual_projector" in n or "shared" in n for n in every)
    with pytest.raises(ValueError, match="matched no kernel"):
        t_lora.init_lora(ex.model, t_lora.from_config(cfg | {"LORA_RANK": 2,
                                                              "LORA_TARGETS": "nope"}), g)


def test_merge_lora_equals_jax(trained):
    _, _, _, _, t_ex, j_params, _, _, _ = trained
    spec = j_lora.from_config(JaxConfig(LORA))
    lora_tree = jax.tree.map(  # a non-zero b, so the merge is not the identity
        lambda x: x if x.shape[-2] != spec.rank else
        np.random.RandomState(x.size).randn(*x.shape).astype(np.float32) * 0.1,
        j_params["lora"])
    want = bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, j_lora.merge_lora(j_params["base"], lora_tree, spec.scale)),
        t_ex.model)
    base = bridge.flax_to_state_dict(j_params["base"], t_ex.model)
    got = t_lora.merge_lora(base, _adapters(lora_tree), spec.scale)
    assert t_lora.unmatched_adapter_paths(base, _adapters(lora_tree)) == []
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_three_lora_steps_match_optax_multi_transform(trained):
    _, _, _, j_ex, t_ex, _, start, j_losses, t_losses = trained
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL, atol=TOL)
    j_now = jax.tree.map(np.asarray, j_ex.state.params)
    want = _adapters(j_now["lora"])
    assert set(want) == set(t_ex.state.lora)
    # adam moves an element by ~lr whatever its gradient's size: where a
    # gradient sat at the frameworks' rounding level (an ``a`` entry in the
    # second step, when ``b`` is ~lr), the two may part by up to 2 lr a step
    lr, n_far, n_all = float(t_ex._lr_schedule(0)), 0, 0
    for name, ad in t_ex.state.lora.items():
        for k in ("a", "b"):
            gap = np.abs(ad[k].detach().numpy() - want[name][k].numpy())
            assert gap.max() <= 2 * lr * STEPS, f"{name}.{k}"
            n_far += int((gap > TOL).sum())
            n_all += gap.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    assert any(float(ad["b"].abs().max()) > 0 for ad in t_ex.state.lora.values())
    for name, p in t_ex.state.params.items():  # the base did not move
        torch.testing.assert_close(p, start[name], atol=0, rtol=0)
    # the module holds the merged weights: what eval decodes with
    merged = t_lora.merge_lora(t_ex.state.params, t_ex.state.lora, t_ex._lora_scale)
    for name, p in t_ex.model.named_parameters():
        torch.testing.assert_close(p, merged[name], atol=0, rtol=0)


def test_the_optimizer_state_covers_the_adapters_only(trained):
    _, _, _, _, t_ex, _, _, _, _ = trained
    names = {f"{n}.{k}" for n in t_ex.state.lora for k in ("a", "b")}
    assert set(t_ex.state.opt_state["mu"]) == set(t_ex.state.opt_state["nu"]) == names
    assert t_ex.state.opt_state["count"] == STEPS
    assert not any(p.requires_grad for p in t_ex.model.parameters())


def test_the_composite_checkpoint_evaluates_without_lora_keys(trained):
    _, j_config, t_cfg, j_ex, t_ex, _, _, _, _ = trained
    t_ex._save_checkpoint("last")
    saved = torch.load(os.path.join(t_cfg.SAVE_PATH, "last_ckp"), weights_only=True)
    assert t_lora.is_composite(saved["params"]) and saved["lora_scale"] == 2.0
    plain = t_config.Config({k: v for k, v in t_cfg.items() if not k.startswith("LORA")})
    ev = T_EXECUTORS.get(plain.EXECUTOR)(plain, "eval", evaltype="last", device="cpu")
    ev._load_trained_checkpoint("last")
    assert ev.state.lora is None
    got = ev.infer(ev.val_data, 4, 8)
    assert got == t_ex.infer(t_ex.val_data, 4, 8)
    assert got == j_ex.infer(j_ex.val_data, 4, 8)
    # the round trip: a LoRA run resumes adapters, base, optimizer and step
    resumed = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    assert resumed.state.step == STEPS and resumed.state.opt_state["count"] == STEPS
    for name, ad in t_ex.state.lora.items():
        torch.testing.assert_close(resumed.state.lora[name]["b"], ad["b"], atol=0, rtol=0)


def test_checkpoints_resume_across_lora_layouts(trained, tmp_path):
    """A composite checkpoint into a run without LoRA is merged with its
    scale; a flat checkpoint into a LoRA run becomes the frozen base with
    fresh zero-b adapters. Step and epoch are kept, the optimizer is new."""
    _, _, t_cfg, _, t_ex, _, _, _, _ = trained
    composite = str(tmp_path / "composite")
    os.makedirs(composite)
    t_ex.ckpt.save_path = composite
    t_ex._save_checkpoint("last")
    flat_cfg = t_config.Config({**t_cfg, "SAVE_PATH": composite, "LORA_RANK": 0})
    flat = T_EXECUTORS.get(flat_cfg.EXECUTOR)(flat_cfg, "train", device="cpu")
    assert flat.state.lora is None and flat.state.step == t_ex.state.step
    merged = t_lora.merge_lora(t_ex.state.params, t_ex.state.lora, t_ex._lora_scale)
    for name, p in flat.state.params.items():
        torch.testing.assert_close(p, merged[name], atol=0, rtol=0)
    assert flat.state.opt_state["count"] == 0

    flat.ckpt.save_path = str(tmp_path / "flat")
    os.makedirs(flat.ckpt.save_path)
    flat._save_checkpoint("last")
    lora_cfg = t_config.Config({**t_cfg, "SAVE_PATH": flat.ckpt.save_path})
    back = T_EXECUTORS.get(lora_cfg.EXECUTOR)(lora_cfg, "train", device="cpu")
    assert back.state.lora is not None and back.state.step == t_ex.state.step
    assert not any(ad["b"].any() for ad in back.state.lora.values())
    for name, p in back.state.params.items():
        torch.testing.assert_close(p, merged[name], atol=0, rtol=0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A bf16 eval-mode LaTr executor, two adapters with non-zero b, and
    the validation requests."""
    root = tmp_path_factory.mktemp("adapters")
    paths = make_latr_fixture(root)
    cfg = t_config.Config(get_config(tiny_latr_yaml(paths, str(root / "ck"), DTYPE="bfloat16",
                                                    max_eval_length=10)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
    ex._ensure_params()
    spec = t_lora.from_config(t_config.Config(LORA))
    adapters = {}
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        tree = t_lora.init_lora(ex.model, spec, g)
        for ad in tree.values():
            ad["b"] = torch.randn(ad["b"].shape, generator=g) * 0.5
        adapters[f"a{seed}"] = {"lora": tree, "scale": spec.scale}
    reqs = [(r["image_id"], r["question"]) for r in synthetic.read_qa_csv(paths["val"])]
    return cfg, ex, adapters, reqs


def _answers(engine, reqs, adapter=None):
    futures = [engine.submit(i, q, adapter=adapter) for i, q in reqs]
    return [f.result(timeout=120) for f in futures]


def test_serving_adapters_answer_as_their_merged_engines(served):
    cfg, ex, adapters, reqs = served
    base = {n: p.detach().clone() for n, p in ex.model.named_parameters()}
    want = {}
    for name, spec in [(None, None), *adapters.items()]:
        other = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "eval", device="cpu")
        params = ex.state.params if spec is None else t_lora.merge_lora(
            ex.state.params, spec["lora"], spec["scale"])
        other.load_params(params)  # a merged checkpoint, served with no adapter
        with ServingEngine(other, *other.serve_frames, batch_size=4, max_wait_ms=20,
                           max_answer_length=10) as eng:
            want[name] = _answers(eng, reqs)
    assert want["a1"] != want[None] or want["a2"] != want[None]
    with ServingEngine(ex, *ex.serve_frames, batch_size=4, max_wait_ms=30, max_answer_length=10,
                       adapters=adapters, cache_size=16) as eng:
        futures = [(route, i, eng.submit(image_id, q, adapter=route))
                   for route in (None, "a1", "a2", "a1") for i, (image_id, q) in enumerate(reqs)]
        got = {(route, i): f.result(timeout=120) for route, i, f in futures}
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.submit(*reqs[0], adapter="nope")
        stats = eng.stats()
        eng._activate(None)
    for route in (None, "a1", "a2"):
        assert [got[(route, i)] for i in range(len(reqs))] == want[route], route
    assert stats["adapter_switches"] >= 2 and stats["failed"] == 0
    for name, p in ex.model.named_parameters():  # the base back, bit for bit
        torch.testing.assert_close(p, base[name], atol=0, rtol=0)


def test_a_mismatched_adapter_fails_fast_and_continuous_refuses(served):
    cfg, ex, adapters, reqs = served
    bad = {"bad": {"lora": {"t5.encoder.block_0.attn.q.weight": {
        "a": torch.zeros(5, 2), "b": torch.zeros(2, 5)}}, "scale": 1.0}}
    with pytest.raises(ValueError, match="does not match the served base"):
        ServingEngine(ex, *ex.serve_frames, batch_size=2, warmup=False, adapters=bad)
    with ContinuousEngine(ex, *ex.serve_frames, num_slots=2, prefill_chunk=2, horizon=2,
                          max_answer_length=6) as eng:
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.submit(*reqs[0], adapter="a1")
    with pytest.raises(SystemExit, match="--adapter"):
        t_serve.build_engine(t_serve.parse_args(
            ["--config-file", "unused.yaml", "--adapter", "a=dir", "--continuous",
             "--device", "cpu"]))


def test_serve_load_adapter_reads_a_lora_run(trained, tmp_path):
    _, _, _, _, t_ex, _, _, _, _ = trained
    t_ex.ckpt.save_path = str(tmp_path)
    t_ex._save_checkpoint("best")
    loaded = t_serve.load_adapter(str(tmp_path), "cpu")
    assert loaded["scale"] == t_ex._lora_scale
    for name, ad in t_ex.state.lora.items():
        torch.testing.assert_close(loaded["lora"][name]["a"], ad["a"].detach(), atol=0, rtol=0)
    flat = tmp_path / "flat"
    flat.mkdir()
    torch.save({"params": t_ex.state.params, "best_score": 0.0}, str(flat / "last_ckp"))
    with pytest.raises(SystemExit, match="not a LoRA composite"):
        t_serve.load_adapter(str(flat), "cpu")
