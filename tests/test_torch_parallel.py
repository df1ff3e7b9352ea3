"""The port across processes (``phoneme_vqa_torch/parallel/``), on the CPU
over gloo, at tiny widths in f32 with dropout 0; the counterpart of
``tests/test_parallel.py``.

* one epoch (one step of 8 rows) at DP 2 (with ``GRAD_CLIP`` and
  ``GRAD_ACCUM_STEPS`` 2), TP 2 (adafactor, its factored statistics reduced
  over the model axis, and the clip), DP 2 x TP 2 (label smoothing through
  the vocab-parallel loss) and ZeRO-1: the loss within rtol 1e-5 of JAX's
  single-device executor on bridged weights and of the port's one process,
  every master within rtol 1e-4 and atol 2e-5 of both (JAX's own mesh test
  tolerance: a normalized step parts elements whose gradient sits at
  rounding level); greedy rows and beam rows identical to one process;
* greedy rows under TP 2 for SaL (the 2D bias tables sliced by head, both
  ``SAL_FUSED`` routes) and PhonemeLaTr (the triple heads whole), beam too;
* the global token mean over ranks with unequal token counts, the loader's
  shards, a batch that does not divide the data axis (raising in training,
  the replicated fallback's one warning in eval), multihost init doing
  nothing in one process;
* the TP plan against JAX's ``tree_shardings`` at full width, per family.

Each mesh runs in spawned processes (``phoneme_vqa_torch.dryrun.run_mesh``);
a spawn of 2 ranks takes ~7 s. The CLI under ``torchrun``, checkpoints
between a mesh and one process, the fine-tuning knobs on a mesh and
``dryrun_multichip(4)``: ``tests/test_torch_parallel_cli.py``.
"""

import logging
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from phoneme_vqa_torch import config as t_config
from phoneme_vqa_torch import train  # noqa: F401  (registers the executors)
from phoneme_vqa_torch.data.loader import ArrayDataset, batch_iterator
from phoneme_vqa_torch.dryrun import _beam_rows, run_mesh
from phoneme_vqa_torch.models import bridge
from phoneme_vqa_torch.parallel import mesh as t_mesh
from phoneme_vqa_torch.parallel.multihost import maybe_initialize_distributed
from phoneme_vqa_torch.train.optim import cross_entropy_loss
from phoneme_vqa_torch.utils.registry import EXECUTORS as T_EXECUTORS
from phoneme_vqa_tpu import registry_setup  # noqa: F401
from phoneme_vqa_tpu.config import get_config
from phoneme_vqa_tpu.utils.registry import EXECUTORS

from .fixtures import make_latr_fixture, make_sal_fixture, tiny_latr_yaml, tiny_sal_yaml
from .test_torch_latr_family_executor import write_annotations

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def latr_paths(tmp_path_factory):
    return make_latr_fixture(tmp_path_factory.mktemp("par_latr"))


@pytest.fixture(scope="module")
def sal_paths(tmp_path_factory):
    return make_sal_fixture(tmp_path_factory.mktemp("par_sal"))


def trio(yaml_path, root, mesh, world, **run):
    """JAX's single-device executor, the port's one process from its
    bridged initial parameters, and the port on ``mesh``: one epoch each.
    Returns (jax executor, port executor, mesh record, jax loss, port
    loss)."""
    j_config = get_config(yaml_path)
    j_ex = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="train")
    t_cfg = t_config.Config({**j_config, "SAVE_PATH": str(root / "one")})
    t_ex = T_EXECUTORS.get(t_cfg.EXECUTOR)(t_cfg, "train", device="cpu")
    init = bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params), t_ex.model)
    t_ex.load_params(init)
    init_path = str(root / "init.pt")
    torch.save(init, init_path)
    record = run_mesh({**t_cfg, "SAVE_PATH": str(root / "mesh"), "MESH": mesh}, world,
                      device="cpu", init=init_path, epochs=1, steps=0, **run)
    return j_ex, t_ex, record, j_ex._train_epoch(1), t_ex._train_epoch(1)


# attention key biases: their gradient is zero in exact arithmetic (the
# softmax ignores a constant added to a query's logits), so what adam's
# normalized first step makes of the rounding noise is up to lr either way
ZERO_GRAD = (".k.bias",)


def assert_masters(got: dict, want: dict, lr: float = 0.0) -> None:
    assert set(got) == set(want)
    for name, value in want.items():
        if name.endswith(ZERO_GRAD):
            assert float((got[name] - value).abs().max()) <= 2 * lr, name
            continue
        torch.testing.assert_close(got[name].float(), value.float(), rtol=RTOL, atol=ATOL,
                                   msg=lambda m, name=name: f"{name}: {m}")


def mesh_params(record) -> dict:
    return torch.load(record["checkpoint"], weights_only=True)["params"]


MESHES = {
    "dp2": ({"data": 2}, 2, dict(GRAD_CLIP=0.5, GRAD_ACCUM_STEPS=2)),
    "tp2": ({"model": 2}, 2, dict(OPTIMIZER="adafactor", LR=1e-2, GRAD_CLIP=0.5)),
    "dp2_tp2": ({"data": 2, "model": 2}, 4, dict(LABEL_SMOOTHING=0.1)),
    "zero1": ({"data": 2, "zero1": True}, 2, dict(GRAD_CLIP=0.5)),
}


@pytest.mark.parametrize("case", list(MESHES))
def test_train_step_matches_one_process_and_jax(latr_paths, tmp_path, case):
    mesh, world, knobs = MESHES[case]
    # JAX on one device (the suite's 8 virtual CPU devices would make its
    # default mesh DP 8)
    yaml_path = tiny_latr_yaml(latr_paths, str(tmp_path / "jax"), SAVE=False,
                               MESH={"data": 1, "model": 1}, **knobs)
    j_ex, t_ex, record, j_loss, t_loss = trio(yaml_path, tmp_path, mesh, world)
    np.testing.assert_allclose(record["losses"][0], j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(record["losses"][0], t_loss, rtol=LOSS_RTOL)
    got = mesh_params(record)
    assert_masters(got, {n: t.detach() for n, t in t_ex.state.params.items()})
    assert_masters(got, bridge.flax_to_state_dict(jax.tree.map(np.asarray, j_ex.state.params),
                                                  t_ex.model))
    assert record["restored_bit_for_bit"] and record["restored_opt_bit_for_bit"]
    # decoding on the mesh: greedy and beam rows of the updated model as one process's
    t_ex.load_params(got)
    batch = t_ex.val_data.gather(np.arange(8 if len(t_ex.val_data) >= 8 else len(t_ex.val_data)))
    rows = t_ex._get_generate_fn(int(t_ex.config.max_eval_length))(t_ex._device_batch(batch))
    assert record["rows"] == rows.tolist()
    assert record["answers"] == t_ex.infer(t_ex.val_data, 8, int(t_ex.config.max_eval_length))
    assert record["beam_rows"] == _beam_rows(t_ex, int(t_ex.config.max_eval_length), 2)
    if case == "dp2":  # the data ranks' rows carried unequal token counts
        labels = t_ex.train_data.arrays["label_ids"][:, 1:]
        order = np.random.RandomState(13 + 1).permutation(len(t_ex.train_data))[:8]
        counts = [int((labels[order[r::2]] != t_ex.tokenizer.pad_token_id).sum())
                  for r in range(2)]
        assert counts[0] != counts[1], counts


def test_global_token_mean_over_unequal_ranks():
    """Two ranks' losses over the global count sum to the one-process token
    mean; the mean of the ranks' own means does not."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 6, 11, generator=g)
    targets = torch.randint(1, 11, (4, 6), generator=g)
    targets[0, 2:] = 0  # rank 0 holds rows 0-1, with fewer tokens than rank 1
    targets[1, 4:] = 0
    whole = cross_entropy_loss(logits, targets, 0)
    count = (targets != 0).sum().float()
    parts = [cross_entropy_loss(logits[r * 2:(r + 1) * 2], targets[r * 2:(r + 1) * 2], 0,
                                count=count) for r in range(2)]
    torch.testing.assert_close(sum(parts), whole, rtol=1e-6, atol=0)
    means = [cross_entropy_loss(logits[r * 2:(r + 1) * 2], targets[r * 2:(r + 1) * 2], 0)
             for r in range(2)]
    assert abs(float(sum(means) / 2 - whole)) > 1e-3


def test_sal_greedy_rows_under_tp(sal_paths, tmp_path):
    """SaL at TP 2: the 1D and cell bias tables sliced by head; greedy rows
    and beam rows as one process's, through the factored bias (SAL_FUSED on)
    and the materialized one (off)."""
    for fused in (True, False):
        cfg = t_config.Config(get_config(tiny_sal_yaml(sal_paths, str(tmp_path / f"s{fused}"),
                                                       SAL_FUSED=fused)))
        one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
        record = run_mesh({**cfg, "MESH": {"model": 2}}, 2, device="cpu", steps=0)
        rows = one._get_generate_fn(int(cfg.max_eval_length))(
            one._device_batch(one.val_data.gather(np.arange(len(one.val_data)))))
        assert record["rows"] == rows.tolist()
        assert record["answers"] == one.infer(one.val_data, 8, int(cfg.max_eval_length))
        assert record["beam_rows"] == _beam_rows(one, int(cfg.max_eval_length), 2)
    from phoneme_vqa_torch.ops import attention as attn_mod

    attn_mod.enable_sal_fused(True)


def test_phoneme_latr_triples_under_tp(latr_paths, tmp_path):
    """PhonemeLaTr at TP 2: the triple decoder's heads (84 / 245 / 10 ids at
    full width) stay whole, its attention and FFN split; greedy and beam
    triples as one process's."""
    kw = dict(EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
              MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", n_head=4, num_decoder_layers=2,
              max_a_length=16, max_eval_length=16, max_predict_length=16,
              annotation_paths=[write_annotations(latr_paths["root"])],
              vocab_path=str(tmp_path / "vocab.json"))
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path / "ck"), **kw)))
    one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")  # writes the vocabulary
    record = run_mesh({**cfg, "MESH": {"model": 2}}, 2, device="cpu", steps=1)
    rows = one._get_generate_fn(int(cfg.max_eval_length))(  # the mesh decodes before its step
        one._device_batch(one.val_data.gather(np.arange(len(one.val_data)))))
    assert record["rows"] == rows.tolist()
    assert record["beam_rows"] == _beam_rows(one, int(cfg.max_eval_length), 2)
    loss = float(one.train_step(one.train_data.gather(np.arange(8))))
    np.testing.assert_allclose(record["losses"][0], loss, rtol=LOSS_RTOL)
    assert_masters(mesh_params(record), {n: t.detach() for n, t in one.state.params.items()},
                   lr=float(one._lr_schedule(0)))


def test_loader_shards_partition_rows():
    ds = ArrayDataset({"x": np.arange(17)})
    shards = [np.concatenate([b["x"] for b, _ in batch_iterator(
        ds, 3, shuffle=True, seed=5, pad_final=False, shard=r, num_shards=3)]) for r in range(3)]
    whole = np.random.RandomState(5).permutation(17)
    assert sorted(np.concatenate(shards).tolist()) == list(range(17))
    for r in range(3):
        assert shards[r].tolist() == whole[r::3].tolist()


def test_train_batch_must_divide_the_data_axis(latr_paths, tmp_path):
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path), SAVE=False)))
    ex = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    ex.mesh = types.SimpleNamespace(dp=3, dp_rank=0)
    with pytest.raises(ValueError, match="must divide the data axis"):
        ex._train_epoch(1)


def test_replicated_fallback_warns_once(caplog):
    mesh = types.SimpleNamespace(dp=2, dp_rank=1, _warned_replicated=False)
    with caplog.at_level(logging.WARNING):
        assert t_mesh.shard_rows(mesh, 5) is None
        assert t_mesh.shard_rows(mesh, 7) is None
    assert sum("REPLICATED" in r.message for r in caplog.records) == 1
    assert t_mesh.shard_rows(mesh, 6) == slice(3, 6)
    batch = {"a": np.arange(6), "b": np.arange(12).reshape(6, 2)}
    assert t_mesh.shard_batch(mesh, batch)["a"].tolist() == [3, 4, 5]
    assert t_mesh.pad_batch_to_devices(5, 2) == 6


def test_multihost_init_is_a_noop_in_one_process(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert maybe_initialize_distributed(t_config.Config({}), device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs one process per device"):
        T_EXECUTORS.get("LaTr_Executor")(t_config.Config({"MESH": {"data": 2}}), "train",
                                         device="cpu")


def test_mesh_dims_cover_the_world():
    assert t_mesh.mesh_dims({"data": -1, "model": 2}, 8) == (4, 2)
    assert t_mesh.mesh_dims(None, 4) == (4, 1)
    with pytest.raises(ValueError, match="needs 8 devices"):
        t_mesh.mesh_dims({"data": 4, "model": 2}, 4)
    with pytest.raises(ValueError, match="every process must be on the mesh"):
        t_mesh.mesh_dims({"data": 1, "model": 2}, 4)


# -- the TP plan against JAX's rule, at full width -----------------------------------

FULL_T5 = dict(t5_vocab_size=36096, d_model=768, d_kv=64, num_heads=12, d_ff=3072,
               num_encoder_layers=2, num_t5_decoder_layers=2, vit_image_size=224,
               vit_patch_size=16, vit_hidden_size=768, vit_num_layers=2, vit_num_heads=12,
               vit_mlp_dim=3072, max_2d_position_embeddings=1024, DTYPE="float32")
FAMILIES = {
    "latr": dict(EXECUTOR="LaTr_Executor", MODEL_CLASS="LaTr",
                 MODEL_MOD_CONFIG_CLASS="LaTr_config"),
    "prestu": dict(EXECUTOR="PreSTU_Executor", MODEL_CLASS="PreSTU",
                   MODEL_MOD_CONFIG_CLASS="PreSTU_config"),
    "sal": dict(EXECUTOR="SaL_Executor", MODEL_CLASS="SaL", MODEL_MOD_CONFIG_CLASS="SaL_config"),
    "customized_sal": dict(EXECUTOR="CustomizedSaL_Executor", MODEL_CLASS="CustomizedSaL",
                           MODEL_MOD_CONFIG_CLASS="CustomizedSaL_config", n_head=12,
                           num_decoder_layers=2, DecodeTokenizer="CharTokenizer"),
    "phoneme_latr": dict(EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
                         MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", n_head=12,
                         num_decoder_layers=2),
}
# leaves JAX splits that the port leaves whole: all under 1 MB (the
# relative-bias tables over their 32 buckets, the custom decoder's answer
# embedding, the triple decoder's three embeddings)
SMALL_WHOLE = ("rel_embedding.weight", "rel1d.weight", "scp.weight", "decoder.embed.weight",
               "onset_embed.weight", "rhyme_embed.weight", "tone_embed.weight")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_plan_splits_every_large_leaf_jax_splits(latr_paths, sal_paths, tmp_path, family):
    from jax.sharding import Mesh

    from phoneme_vqa_tpu.parallel.mesh import MODEL_AXIS, tree_shardings

    over = dict(FULL_T5, **FAMILIES[family], SAVE=False)
    if family.startswith("phoneme"):
        over.update(annotation_paths=[write_annotations(latr_paths["root"])],
                    vocab_path=str(tmp_path / "vocab.json"))
    make = tiny_sal_yaml if "sal" in family else tiny_latr_yaml
    paths = sal_paths if "sal" in family else latr_paths
    j_config = get_config(make(paths, str(tmp_path / "jax"), **over))
    # serve mode on both sides: JAX's params abstract (jax.eval_shape), the
    # port's model on the meta device, nothing allocated
    abstract = EXECUTORS.get(j_config.EXECUTOR)(j_config, mode="serve").state.params
    devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
    shardings = tree_shardings(Mesh(devices, ("data", "model")), abstract)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(abstract)[0])
    flat_s = dict(jax.tree_util.tree_flatten_with_path(shardings)[0])
    t_model = T_EXECUTORS.get(j_config.EXECUTOR)(t_config.Config({**j_config}), "serve",
                                                 device="cpu").model
    plan = t_mesh.tp_plan(t_model, 2)
    shapes = {n: tuple(p.shape) for n, p in t_model.named_parameters()}
    missed, whole_small = [], []
    for path, leaf in flat_j.items():
        spec = flat_s[path].spec
        if MODEL_AXIS not in tuple(spec):
            continue
        flax_dim = tuple(spec).index(MODEL_AXIS)
        name, _ = bridge._torch_leaf(tuple(getattr(p, "key", str(p)) for p in path),
                                     np.zeros((1,) * len(leaf.shape)))
        torch_dim = (1 - flax_dim) if path[-1].key == "kernel" and len(leaf.shape) == 2 \
            else flax_dim
        assert name in shapes, name
        if plan.get(name) == torch_dim:
            continue
        if leaf.size * 4 <= 2**20:
            whole_small.append(name)
        else:
            missed.append((name, leaf.shape, flax_dim, plan.get(name)))
    assert not missed, missed
    assert all(n.endswith(SMALL_WHOLE) for n in whole_small), whole_small
    # and every split divides: heads of every split attention, vocab of the embedding
    for name, dim in plan.items():
        assert shapes[name][dim] % 2 == 0, name


@pytest.mark.parametrize("family", ["latr", "phoneme_latr"])
def test_tp_dropout_matches_one_process(latr_paths, tmp_path, family):
    """Dropout 0.1 at TP 2: each rank's FFN inner activation (the T5 FFN's,
    and the custom decoder layer's for PhonemeLaTr) takes its slice of one
    full-width mask, so the step draws one process's masks: loss and masters
    as one process's."""
    kw = dict(dropout_rate=0.1)
    if family == "phoneme_latr":
        kw.update(EXECUTOR="PhonemeLaTr_Executor", MODEL_CLASS="PhonemeLaTr",
                  MODEL_MOD_CONFIG_CLASS="CustomizedLaTr_config", n_head=4,
                  num_decoder_layers=2, max_a_length=16, max_eval_length=16,
                  max_predict_length=16,
                  annotation_paths=[write_annotations(latr_paths["root"])],
                  vocab_path=str(tmp_path / "vocab.json"))
    cfg = t_config.Config(get_config(tiny_latr_yaml(latr_paths, str(tmp_path / "ck"), **kw)))
    one = T_EXECUTORS.get(cfg.EXECUTOR)(cfg, "train", device="cpu")
    record = run_mesh({**cfg, "MESH": {"model": 2}}, 2, device="cpu", steps=1, beams=0)
    loss = float(one.train_step(one.train_data.gather(np.arange(8))))
    np.testing.assert_allclose(record["losses"][0], loss, rtol=LOSS_RTOL)
    # a gradient at rounding level (~1e-9 against its row's 1e-2) takes an
    # adam first step of up to lr whose size the TP summation order sets:
    # every master within 2 lr, all but 0.1 % within RTOL / ATOL
    lr = float(one._lr_schedule(0))
    got = mesh_params(record)
    apart = total = 0
    for name, value in one.state.params.items():
        gap = (got[name].float() - value.detach().float()).abs()
        assert float(gap.max()) <= 2 * lr, name
        apart += int((gap > ATOL + RTOL * value.detach().float().abs()).sum())
        total += gap.numel()
    assert apart <= 1e-3 * total, (apart, total)
