"""Base executor: train / eval / predict (counterpart of
``phoneme_vqa_tpu/train/base_executor.py``, the parts the LaTr path uses).

* the constructor branches on mode; ``run()`` dispatches to ``train``,
  ``evaluate`` or ``predict``;
* train: per-epoch train + metric eval, ``metrics.jsonl``, best/last
  checkpoints on Accuracy (``best_ckp`` seeded on the first epoch),
  ``EARLY_STOP_PATIENCE``, auto-resume from ``last_ckp`` then ``best_ckp``;
* evaluate: load the ``evaltype`` checkpoint, compute the metric dict;
* serve: the tokenizers, the feature stores (``serve_frames``) and the
  model; no QA CSV is read. The model stays on the meta device until a
  checkpoint is restored into it or, failing that, :meth:`_ensure_params`
  draws its random init at first use (``serve --ckpt none``);
* predict: load the ``predicttype`` checkpoint, write ``results.json``
  (``[{"gens", "gts"}]`` with ``get_predict_score``, else ``[{"gens"}]``;
  ``PREDICT_SCORES`` adds ``"confidence"``, exp of the answer's mean
  log-probability);
* metrics dedup consecutive repeated answers and key samples "0_", "1_", ...
* decode: greedy by default; ``SAMPLE`` (``TEMPERATURE``, ``TOP_K``,
  ``TOP_P``, ``SEED``) samples, ``SPEC_DECODE: K`` verifies prompt-lookup
  drafts K tokens a trip, and ``EVAL_CONTINUOUS`` routes ``infer`` through
  the slot-refill pool decode (``EVAL_SLOTS``, ``EVAL_POOL_ROWS``);
  the customized executors add beam search (``isgreedy``, ``num_beam``).

A train step is three parts, each its own method so a caller can time
them: the forward and loss (:meth:`forward_loss`), ``loss.backward()``, and
the optimizer (:meth:`apply_gradients`), which updates the f32 masters
(``train/state.py``) and refreshes the module's bf16 compute weights from
them. The port runs on the device the caller names (never the config's
``DEVICE``), on one device. ``SAL_FUSED`` sets the SaL kernel's dispatch
(``ops.attention.enable_sal_fused``), as in the JAX package. Every JAX knob
the port does not have yet raises when it is set (:func:`check_unported`).

Fine-tuning knobs, as the JAX executor has them: ``LORA_RANK`` (adapters
trained over a frozen base, ``train/lora.py``), ``EMA_DECAY`` (an average
that eval prefers, ``EVAL_EMA``), ``GRAD_ACCUM_STEPS`` (microbatches, one
update), ``REMAT`` (each T5 block recomputed in the backward,
``models/t5.py: remat_block``), ``SAVE_EVERY_STEPS`` (mid-epoch ``last_ckp``,
resumed at the next batch), ``VIT_CACHE`` (``data/vit_cache.py``) and a
params-only resume of a converted or optimizer-mismatched checkpoint.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import pickle
import time
from typing import Dict, List

import numpy as np
import torch

from .. import evaluation
from ..config import Config
from ..data.loader import batch_iterator, num_batches
from ..data.vit_cache import attach_vit_cache
from ..decode.pool import CACHE_KEYS, pool_greedy_decode
from ..decode.sample import sample_generator
from ..models.generate import (
    build_generate_fn,
    decode_token_ids,
    make_sample_generate_fn,
    make_speculative_generate_fn,
)
from ..models.latr import to_device_batch
from ..ops import attention as attn_mod
from ..serving.engine import decode_rows
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.registry import MODELS
from .optim import cross_entropy_loss
from . import lora as lora_mod
from .state import (
    bind_params,
    compute_copies,
    ema_update_,
    master_grads,
    refresh_compute_weights_,
    tree_map,
    tree_shapes,
)

log = get_logger(__name__)

LABEL_KEYS = ("label_ids", "label_attention_mask")


def _mesh_devices(mesh) -> int:
    if not mesh:
        return 1
    n = 1
    for axis in ("data", "model"):
        size = int(mesh.get(axis, 1) or 1)
        n *= 1 if size == -1 else size  # -1: every device there is, one here
    return n


# (key, is it set?, ROADMAP item): JAX knobs the port does not have
UNPORTED = (
    ("SCAN_LAYERS", lambda v: bool(v),
     "A12: refused, an XLA compile means; models/bridge.py reads stacked trees"),
    ("FEATURE_CACHE", lambda v: bool(v), "A12"),
    ("PROFILE_DIR", lambda v: bool(v), "A12"),
    ("DEBUG_NANS", lambda v: bool(v), "A12"),
    ("NUMWORKERS", lambda v: bool(v), "A12"),
    ("MESH", lambda v: _mesh_devices(v) > 1, "A15"),
    ("FLASH", lambda v: v is not None, "B1: the port always runs its kernel on the card"),
)


def check_unported(config) -> None:
    """Raises NotImplementedError naming every set knob of ``UNPORTED``."""
    found = [f"{key}={config.get(key)!r} (ROADMAP {item})" for key, is_set, item in UNPORTED
             if is_set(config.get(key))]
    if found:
        raise NotImplementedError(f"not ported yet: {'; '.join(found)}")


class BaseExecutor:
    # keys every train run needs; executor families extend them with their
    # data paths
    REQUIRED_TRAIN_KEYS: tuple = (
        "EXECUTOR", "NUM_EPOCHS", "LR", "BETAS",
        "TRAIN_BATCH_SIZE", "EVAL_BATCH_SIZE",
        "max_q_length", "max_a_length", "max_eval_length",
        "qa_train_path", "qa_val_path",
        "MODEL_CLASS", "MODEL_MOD_CONFIG_CLASS",
    )

    def __init__(self, config, mode: str = "train", evaltype: str = "last",
                 predicttype: str = "best", device="cuda"):
        log.info("---Initializing Executor---")
        self.config = config if isinstance(config, Config) else Config(config)
        self.mode = mode
        self.evaltype = evaltype
        self.predicttype = predicttype
        self.device = resolve_device(device)
        self.best_score = 0.0
        self._generate_fns: Dict = {}
        check_unported(self.config)
        if self.config.get("SAL_FUSED") is not None:
            attn_mod.enable_sal_fused(bool(self.config.get("SAL_FUSED")))
        if mode == "train":
            self.config.require(*self.REQUIRED_TRAIN_KEYS)
            self._create_data_utils()
            self._build_model()
            self._init_training_properties()
        elif mode in ("eval", "predict"):
            self.config.require("qa_predict_path" if mode == "predict" else "qa_val_path")
            self._init_eval_predict_mode()
            self._build_model()
        elif mode == "serve":
            self._init_serve_mode()
            self._build_model()
        else:
            raise ValueError(f"unknown mode {mode!r}")

    @property
    def model_class(self):
        """The configured model's class (``MODEL_CLASS``): it names the
        model's inputs (``BATCH_KEYS``) and, in the LaTr / PreSTU families,
        the dataset that featurizes them (``DATASET``)."""
        return MODELS.get(self.config.MODEL_CLASS)

    # -- subclass hooks -------------------------------------------------------

    def _create_data_utils(self):
        raise NotImplementedError

    def _init_eval_predict_mode(self):
        raise NotImplementedError

    def _init_serve_mode(self):
        raise NotImplementedError

    def _build_model(self):
        raise NotImplementedError

    def _init_training_properties(self):
        raise NotImplementedError

    # -- run ------------------------------------------------------------------

    def run(self):
        if self.mode == "train":
            log.info("# Training on epochs... #")
            return self.train()
        if self.mode == "eval":
            return self.evaluate()
        return self.predict()

    def train(self):
        os.makedirs(self.config.SAVE_PATH or "./models", exist_ok=True)
        log.info("#----------- START TRAINING -----------------#")
        self._maybe_attach_vit_cache(("train_data", "val_data"))
        t_start = time.perf_counter()
        start_epoch = int(self.state.epoch)
        # EARLY_STOP_PATIENCE: stop after N epochs without an Accuracy
        # improvement (0/absent = a fixed number of epochs); a resumed run
        # gets a full patience window
        patience = int(self.config.get("EARLY_STOP_PATIENCE", 0) or 0)
        best_epoch, best_acc = start_epoch, 0.0

        for epoch in range(start_epoch + 1, self.config.NUM_EPOCHS + 1):
            t_ep = time.perf_counter()
            train_loss = self._train_epoch(epoch)
            scores = self._evaluate_metrics()
            acc = scores["Accuracy"]
            val_loss = self.validate_loss() if self.config.get("VAL_LOSS") else None
            log.info(
                f"Epoch {epoch}: loss={train_loss:.4f} "
                + (f"val_loss={val_loss:.4f} " if val_loss is not None else "")
                + f"({time.perf_counter() - t_ep:.1f}s) {scores}"
            )
            if acc > best_acc:
                best_acc, best_epoch = acc, epoch

            self.state.epoch = epoch
            self._log_metrics(
                {"epoch": epoch, "train_loss": float(train_loss),
                 "lr": float(self._lr_schedule(int(self.state.step))),
                 **({"val_loss": float(val_loss)} if val_loss is not None else {}),
                 **{k: (list(map(float, v)) if isinstance(v, (list, tuple)) else float(v))
                    for k, v in scores.items()}}
            )
            if self.config.SAVE:
                # the reference saves best only on strict improvement; best_ckp
                # is also seeded on the first epoch so predict-from-best works
                if acc > self.best_score or not self.ckpt.exists("best"):
                    self.best_score = max(self.best_score, acc)
                    self._save_checkpoint("best")
                self._save_checkpoint("last")

            if patience and epoch - best_epoch >= patience:
                log.info(f"# Early stop at epoch {epoch}: no Accuracy improvement for "
                         f"{patience} epochs (best {best_acc:.4f} @ {best_epoch})")
                break

        log.info(f"\n# BEST RESULT:\n\tEpoch: {best_epoch}\n\tBest Accuracy: {best_acc:.4f}")
        log.info(f"#----------- TRAINING END-Time: {time.perf_counter() - t_start} ----#")
        return best_acc

    def evaluate(self):
        log.info("###Evaluate Mode###")
        self._load_trained_checkpoint(self.evaltype)
        self._maybe_attach_vit_cache(("val_data",))
        scores = self._evaluate_metrics()
        log.info("\t#EVALUATION:\n")
        log.info(scores)
        return scores

    def predict(self):
        log.info("###Predict Mode###")
        self._load_trained_checkpoint(self.predicttype)
        self._maybe_attach_vit_cache(("predict_data",))
        log.info("## START PREDICTING ... ")
        if self.config.get_predict_score:
            results, scores = self._evaluate_metrics(return_results=True)
            log.info("\t#PREDICTION:\n")
            log.info(f"\t{scores}")
        else:
            want_conf = bool(self.config.get("PREDICT_SCORES"))
            preds = self.infer(self.predict_data, self.config.PREDICT_BATCH_SIZE,
                               self.config.max_predict_length, return_scores=want_conf)
            if want_conf:
                results = [{"gens": p, "confidence": math.exp(c)} for p, c in zip(*preds)]
            else:
                results = [{"gens": p} for p in preds]
        out_path = os.path.join(self.config.SAVE_PATH or ".", "results.json")
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=4)
        log.info("Saved Results !")
        return results

    # -- metrics ---------------------------------------------------------------

    def _evaluate_metrics(self, return_results: bool = False):
        # PREDICT_SCORES adds each answer's confidence to results.json; the
        # schema is unchanged without it
        want_conf = return_results and bool(self.config.get("PREDICT_SCORES"))
        confs = None
        if self.mode == "predict":
            preds = self.infer(self.predict_data, self.config.PREDICT_BATCH_SIZE,
                               self.config.max_predict_length, return_scores=want_conf)
            if want_conf:
                preds, confs = preds
            answers_gt = [a.strip() for a in self.predict_answer]
        else:
            preds = self.infer(self.val_data, self.config.EVAL_BATCH_SIZE,
                               self.config.max_eval_length)
            answers_gt = [a.strip() for a in self.val_answer]

        answers_gen = [[p.strip()] for p in preds]
        gens, gts = {}, {}
        for i, (gt_i, gen_i) in enumerate(zip(answers_gt, answers_gen)):
            # dedup consecutive repeats, as the reference does
            gens[f"{i}_"] = [" ".join(k for k, _ in itertools.groupby(gen_i))]
            gts[f"{i}_"] = [gt_i]

        score, _ = evaluation.compute_scores(gts, gens)
        if self.mode == "predict" and return_results:
            results = [{"gens": gen, "gts": gt} for gen, gt in zip(answers_gen, answers_gt)]
            if confs is not None:
                for row, c in zip(results, confs):
                    row["confidence"] = math.exp(c)
            return results, score
        return score

    @torch.no_grad()
    def validate_loss(self, batch_size: int = None) -> float:
        """Mean teacher-forced loss (no dropout) over the full validation
        batches."""
        batch_size = batch_size or self.config.EVAL_BATCH_SIZE
        self.model.eval()
        total, n = 0.0, 0
        for batch, _ in batch_iterator(self.val_data, batch_size, drop_last=True):
            total += float(self._loss_from_batch(self._to_device(batch)))
            n += 1
        return total / max(n, 1)

    # -- checkpointing -----------------------------------------------------------

    def _ckpt_params(self):
        """The checkpoint's params tree: the masters, or ``{"base",
        "lora"}`` under LoRA."""
        if self.state.lora is not None:
            return {"base": self.state.params, "lora": self.state.lora}
        return self.state.params

    def _ckpt_tree(self) -> dict:
        tree = {
            "params": self._ckpt_params(),
            "opt_state": self.state.opt_state,
            "step": int(self.state.step),
            "epoch": int(self.state.epoch),
            # 0 at epoch boundaries; > 0 for a SAVE_EVERY_STEPS mid-epoch
            # checkpoint: resume continues the epoch from the next batch (the
            # shuffle is seeded per epoch, so the rest of the trajectory is
            # the uninterrupted run's)
            "step_in_epoch": int(getattr(self, "_step_in_epoch", 0)),
            "best_score": float(self.best_score),
        }
        if self.state.ema_params is not None:
            tree["ema_params"] = self.state.ema_params
        if self.state.lora is not None:
            # eval, predict and serve merge with it and need no LORA_* keys
            tree["lora_scale"] = float(self._lora_scale)
        return tree

    def _save_checkpoint(self, name: str):
        self.ckpt.save(name, self._ckpt_tree())

    def _log_metrics(self, record: dict) -> None:
        """One JSON line per epoch appended to SAVE_PATH/metrics.jsonl."""
        if not self.config.get("SAVE_PATH"):
            return
        record = dict(record, step=int(self.state.step), wall_time=time.time())
        os.makedirs(self.config.SAVE_PATH, exist_ok=True)
        with open(os.path.join(self.config.SAVE_PATH, "metrics.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps(record, ensure_ascii=False) + "\n")

    def _check_params(self, params) -> None:
        want = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        got = {n: tuple(p.shape) for n, p in params.items()}
        if got != want:
            raise ValueError(f"checkpoint parameters differ from the model's: "
                             f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")

    def _maybe_resume(self):
        """Resume the full training state from last_ckp, else best_ckp. A
        checkpoint whose optimizer state (or LoRA layout) does not fit
        resumes its parameters with a fresh optimizer
        (:meth:`_try_params_only_resume`); an unreadable one is skipped with
        a warning, down to a fresh start."""
        for name in ("last", "best"):
            if not self.ckpt.exists(name):
                continue
            try:
                restored = self.ckpt.restore(name, self.device)
            except (OSError, EOFError, pickle.UnpicklingError, RuntimeError, ValueError,
                    KeyError) as e:
                log.warning(f"(!) {name}_ckp exists but is unreadable ({e!r}): falling back to "
                            "an older checkpoint / fresh start")
                continue
            if self._try_full_resume(restored):
                log.info(f"###Resumed from {name}_ckp (epoch {self.state.epoch}"
                         + (f", step {self._resume_step_in_epoch} into epoch "
                            f"{self.state.epoch + 1}" if self._resume_step_in_epoch else "")
                         + ")")
                return
            if self._try_params_only_resume(restored):
                log.info(f"###Resumed PARAMS ONLY from {name}_ckp (converted, partial or "
                         f"optimizer-mismatched checkpoint): the optimizer starts fresh at "
                         f"step {self.state.step}")
                return
            log.warning(f"(!) {name}_ckp does not fit this model: falling back to an older "
                        "checkpoint / fresh start")

    def _resume_counters(self, restored: dict) -> None:
        self.state.step = int(restored.get("step", 0))
        self.state.epoch = int(restored.get("epoch", 0))
        self.best_score = float(restored.get("best_score", 0.0))
        self._resume_step_in_epoch = int(restored.get("step_in_epoch", 0) or 0)

    def _try_full_resume(self, restored: dict) -> bool:
        """Params, optimizer state, EMA and counters, when every shape
        matches this run's."""
        params, opt = restored.get("params"), restored.get("opt_state")
        if not isinstance(params, dict) or not isinstance(opt, dict):
            return False
        mine = self._ckpt_params()
        fresh = self.state.opt_state
        try:
            same = (tree_shapes(params) == tree_shapes(mine)
                    and set(opt) == set(fresh)
                    and all(k == "count" or tree_shapes(opt[k]) == tree_shapes(fresh[k])
                            for k in fresh))
        except (AttributeError, TypeError):
            return False
        if not same:
            return False
        self._set_trained_params(params)
        self.state.opt_state = opt
        self._bind_optimizer()
        if self.state.ema_params is not None:
            self.state.ema_params = self._salvage_ema(restored)
        self._resume_counters(restored)
        return True

    def _salvage_ema(self, raw: dict):
        """An EMA run resumed from a checkpoint: its saved average when it
        matches the params tree, else the average re-seeded from the params."""
        ema = raw.get("ema_params")
        mine = self._ckpt_params()
        if isinstance(ema, dict) and tree_shapes(ema) == tree_shapes(mine):
            return tree_map(lambda t: t.to(self.device), ema)
        return tree_map(lambda t: t.detach().clone(), mine)

    def _try_params_only_resume(self, raw: dict) -> bool:
        """Salvage the params of a checkpoint whose full restore does not fit:
        a params-only one (a converted reference checkpoint), or one whose
        optimizer state no longer matches (``OPTIMIZER`` switched). A LoRA
        composite into a run without LoRA is merged with its saved scale; a
        flat checkpoint into a LoRA run becomes the frozen base (the fresh
        zero-``b`` adapters keep the merged model identical); LoRA into LoRA
        keeps the trained adapters when their shapes match. Step, epoch and
        the position in the epoch are kept; the optimizer starts fresh."""
        params = raw.get("params")
        if not isinstance(params, dict):
            return False
        adapters = None
        if lora_mod.is_composite(params):
            if self.state.lora is None:
                params = lora_mod.merge_lora(params["base"], params["lora"],
                                             float(raw.get("lora_scale", 1.0)))
            else:
                if tree_shapes(params["lora"]) == tree_shapes(self.state.lora):
                    adapters = params["lora"]
                params = params["base"]
        try:
            self._check_params(params)
        except ValueError:
            return False
        if self.state.lora is not None:
            params = {"base": params,
                      "lora": adapters if adapters is not None else self.state.lora}
        self._set_trained_params(params)
        self.state.opt_state = self.tx.init(self._opt_params())
        self._bind_optimizer()
        if self.state.ema_params is not None:
            self.state.ema_params = self._salvage_ema(raw)
        self._resume_counters(raw)
        return True

    def _load_trained_checkpoint(self, loadtype: str):
        """Eval/predict/serve: the checkpoint's parameters into the model
        (cast to its compute dtype); no optimizer state. The EMA weights are
        preferred where the checkpoint has them (``EVAL_EMA: false`` opts
        out); a LoRA composite is merged with its saved ``lora_scale``."""
        restored = self.ckpt.restore(loadtype, self.device)
        source = "params"
        if "ema_params" in restored and self.config.get("EVAL_EMA", True):
            source = "ema_params"
            log.info("## using EMA weights from the checkpoint")
        params = restored[source]
        if lora_mod.is_composite(params):
            params = lora_mod.merge_lora(params["base"], params["lora"],
                                         float(restored.get("lora_scale", 1.0)))
        self._check_params(params)
        self.load_params(params)
        self.best_score = float(restored["best_score"])

    # -- serve mode's deferred init ----------------------------------------------

    _abstract_params = False  # serve mode: the model is on the meta device

    def _materialize(self) -> None:
        """The meta-device model on ``self.device``, its values unset."""
        self.model = self.model.to_empty(device=self.device)
        self._abstract_params = False

    def _ensure_params(self) -> Dict[str, torch.Tensor]:
        """The masters, after drawing the random init of a serve-mode model
        that no checkpoint restore reached first: the values the eager init
        of the other modes gives (``SEED``), drawn at first use."""
        if self._abstract_params:
            log.info("# no checkpoint restored: materializing random-init params")
            self._materialize()
            self.state.params = bind_params(self.model, self._random_params())
        return self.state.params

    def _random_params(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def load_params(self, params: Dict[str, torch.Tensor], lora=None) -> None:
        """Every parameter by name, in f32 (a checkpoint's masters, or a
        flax tree through ``models.bridge.flax_to_state_dict``), into the
        model and the train state; in train mode the optimizer state starts
        afresh. Under LoRA ``params`` is the frozen base, and ``lora`` (by
        default the current adapters) its adapters. The values are copied
        into the parameters' own storage, so whatever holds their addresses
        (the serving engines' captured CUDA graphs) reads the new ones."""
        if self._abstract_params:
            self._materialize()
        if self.state.lora is not None:
            params = {"base": params, "lora": self.state.lora if lora is None else lora}
        self._set_trained_params(params)
        if self.mode == "train":
            self.state.opt_state = self.tx.init(self._opt_params())
            self._bind_optimizer()
            if self.state.ema_params is not None:
                self.state.ema_params = tree_map(lambda t: t.detach().clone(),
                                                 self._ckpt_params())

    def _set_trained_params(self, params) -> None:
        """A params tree (flat, or ``{"base", "lora"}`` under LoRA) into the
        model and the state. Under LoRA the adapted weights' base masters
        are tensors of their own and the module holds the merged weights
        (what eval and predict decode with)."""
        self._uninstall_lora()
        if self.state.lora is None:
            self.state.params = bind_params(self.model, params)
            return
        masters = bind_params(self.model, params["base"])
        self.state.params = {n: t.detach().clone() if n in params["lora"] and
                             t is self.model.get_parameter(n) else t
                             for n, t in masters.items()}
        self.state.lora = {n: {k: v.detach().to(self.device, torch.float32).clone()
                               .requires_grad_(True) for k, v in ad.items()}
                           for n, ad in params["lora"].items()}
        self._refresh_lora_weights()

    def _opt_params(self) -> Dict[str, torch.Tensor]:
        """What the optimizer updates, by name: the masters, or under LoRA
        the adapters alone (``{weight name}.a`` / ``.b``): the base holds no
        optimizer state."""
        if self.state.lora is None:
            return self.state.params
        return {f"{n}.{k}": t for n, ad in self.state.lora.items() for k, t in ad.items()}

    def _bind_optimizer(self):
        self._trainable = [n for n in self._opt_params() if self.tx.trainable(n)]
        lora_on = self.state.lora is not None
        self._copies = [] if lora_on else compute_copies(self.model, self.state.params,
                                                         self._trainable)
        trainable = set(self._trainable)
        for name, p in self.model.named_parameters():
            p.requires_grad_(not lora_on and name in trainable)

    # -- LoRA ---------------------------------------------------------------------

    def _maybe_enable_lora(self) -> None:
        """``LORA_RANK: N`` (train mode): adapters for the targeted weights
        (``train/lora.py``; ``a`` drawn from ``SEED + 1``), the model's
        parameters frozen as the base."""
        spec = lora_mod.from_config(self.config)
        if spec is None:
            return
        generator = torch.Generator(device=self.device).manual_seed(
            int(self.config.get("SEED", 13)) + 1)
        adapters = lora_mod.init_lora(self.model, spec, generator, self.device)
        self._lora_scale = spec.scale
        self.state.lora = {}  # LoRA on: _set_trained_params splits base and adapters
        self._set_trained_params({"base": self.state.params, "lora": adapters})
        log.info(f"# LoRA: rank {spec.rank}, alpha {spec.alpha}, "
                 f"{lora_mod.n_params(adapters) / 1e6:.2f}M trainable adapter params "
                 f"({lora_mod.n_params(self.state.params) / 1e6:.1f}M base frozen)")

    @torch.no_grad()
    def _refresh_lora_weights(self) -> None:
        """The module's adapted weights := base + scale * (A @ B)^T, in their
        compute dtype, in place."""
        for name, ad in self.state.lora.items():
            p = self.model.get_parameter(name)
            p.copy_(lora_mod.merged_weight(self.state.params[name], ad, self._lora_scale))

    def _install_lora(self) -> None:
        """The adapted weights rebuilt from the adapters with their autograd
        graph and put in the modules' place until :meth:`_uninstall_lora`
        (after the optimizer): a REMAT recompute in the backward reads the
        same tensors."""
        self._uninstall_lora()
        installed = []
        for name, ad in self.state.lora.items():
            module_name, _, leaf = name.rpartition(".")
            module = self.model.get_submodule(module_name)
            weight = module._parameters[leaf]
            merged = lora_mod.merged_weight(self.state.params[name], ad, self._lora_scale)
            module._parameters[leaf] = merged.to(weight.dtype)
            installed.append((module, leaf, weight))
        self._lora_installed = installed

    def _uninstall_lora(self) -> None:
        for module, leaf, weight in getattr(self, "_lora_installed", ()):
            module._parameters[leaf] = weight
        self._lora_installed = []

    # -- train / infer ---------------------------------------------------------

    def _freeze_predicate(self):
        """The model's structural ViT freeze (the reference freezes its ViT
        with ``requires_grad=False``): the ``vit`` parameters take no
        gradient, no optimizer state and no update, so no update rule
        (decoupled weight decay included) moves them. Under LoRA the
        optimizer sees the adapters alone (:meth:`_opt_params`)."""
        if self.state.lora is not None or not getattr(self.model_config, "freeze_vit", False):
            return None
        return lambda name: name.split(".", 1)[0] == "vit"

    def _batch_keys(self, batch_keys: tuple) -> tuple:
        """``VIT_CACHE``: a dataset with cached encodings feeds
        ``vit_encodings`` in place of ``pixel_values``."""
        if "pixel_values" in batch_keys:
            return batch_keys + ("vit_encodings",)
        return batch_keys

    def _model_batch(self, batch: dict) -> dict:
        keys = self.model_class.BATCH_KEYS
        if "vit_encodings" in batch and "pixel_values" in keys:
            keys = tuple(k for k in keys if k != "pixel_values") + ("vit_encodings",)
        return {k: batch[k] for k in keys}

    def _to_device(self, batch: dict) -> dict:
        return to_device_batch(batch, self.device,
                               self._batch_keys(self.model_class.BATCH_KEYS) + LABEL_KEYS)

    def _loss_from_batch(self, batch) -> torch.Tensor:
        """Teacher-forced loss of a device batch in the model's current mode:
        ``labels[:, :-1]`` in, ``labels[:, 1:]`` scored."""
        labels = batch["label_ids"]
        label_mask = batch["label_attention_mask"]
        logits = self.model(self._model_batch(batch), labels[:, :-1], label_mask[:, :-1])
        return cross_entropy_loss(logits, labels[:, 1:], self._loss_pad_id(),
                                  label_smoothing=self._label_smoothing())

    def _loss_pad_id(self) -> int:
        """The label id the loss ignores: the decoding vocabulary's pad."""
        return self.tokenizer.pad_token_id

    def _label_smoothing(self) -> float:
        """YAML ``LABEL_SMOOTHING`` in [0, 1); 0/absent = plain CE."""
        a = float(self.config.get("LABEL_SMOOTHING", 0) or 0)
        if a and not (0.0 < a < 1.0):
            raise ValueError(f"LABEL_SMOOTHING must be in [0, 1), got {a}")
        return a

    def _ema_decay(self) -> float:
        """``EMA_DECAY`` in (0, 1): keep an exponential moving average of the
        params, updated after every step; checkpoints hold it and eval,
        predict and serve prefer it (``EVAL_EMA: false`` opts out).
        0/absent = off."""
        d = float(self.config.get("EMA_DECAY", 0) or 0)
        if d and not (0.0 < d < 1.0):
            raise ValueError(f"EMA_DECAY must be in (0, 1), got {d}")
        return d

    def _grad_accum_steps(self) -> int:
        """``GRAD_ACCUM_STEPS: N`` splits each batch into N sequential
        microbatches and applies one optimizer update: the loss and the
        gradients are the mean of the microbatches' (each microbatch's
        token-mean CE weighted equally, the JAX executor's rule; that is the
        batch's token mean only when the microbatches count the same
        tokens)."""
        accum = int(self.config.get("GRAD_ACCUM_STEPS", 1) or 1)
        bs = int(self.config.TRAIN_BATCH_SIZE)
        if accum > 1 and bs % accum:
            raise ValueError(f"GRAD_ACCUM_STEPS={accum} must divide TRAIN_BATCH_SIZE={bs}: "
                             "each microbatch is batch/accum rows")
        return accum

    def forward_loss(self, batch, micro=None) -> torch.Tensor:
        """The train step's forward: training mode, dropout drawn from
        ``(SEED, step)``, or ``(SEED, step, micro)`` for microbatch ``micro``
        of an accumulated step (every dropout site of the model, a custom
        decoder's included, draws from ``model.t5.dropout_rng``), the loss of
        a device batch. Under LoRA the adapted weights are rebuilt from the
        adapters first."""
        self.model.train()
        self.model.t5.dropout_rng.reseed(self.config.get("SEED", 13), self.state.step, micro)
        if self.state.lora is not None:
            self._install_lora()
        return self._loss_from_batch(batch)

    def _collect_grads(self) -> Dict[str, torch.Tensor]:
        """The f32 gradient of everything the optimizer updates (zeros where
        the forward gave none), read off the module or the adapters, which
        are then cleared."""
        if self.state.lora is not None:  # the module's own weights take no gradient
            grads = {n: torch.zeros_like(t) if t.grad is None else t.grad
                     for n, t in self._opt_params().items()}
            for t in self._opt_params().values():
                t.grad = None
            return grads
        grads = master_grads(self.model, self.state.params, self._trainable)
        self.model.zero_grad(set_to_none=True)
        return grads

    def _scale_grads_(self, grads: Dict[str, torch.Tensor]) -> None:
        """A hook on the step's f32 gradients before the optimizer (the
        customized executors' encoder freeze)."""

    def apply_gradients(self, grads=None) -> None:
        """The train step's optimizer: the gradients (the module's, cast up
        into f32 master gradients, unless ``grads`` are given) update the
        masters or the adapters; the compute weights are refreshed from
        them, the EMA moves, and the gradients are dropped."""
        if grads is None:
            grads = self._collect_grads()
        self._scale_grads_(grads)
        self.tx.update_(self._opt_params(), grads, self.state.opt_state)
        if self.state.lora is not None:
            self._uninstall_lora()
            self._refresh_lora_weights()
        else:
            refresh_compute_weights_(self._copies)
        if self.state.ema_params is not None:
            ema_update_(self.state.ema_params, self._ckpt_params(), self._ema_decay())
        self.state.step += 1

    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a numpy batch; returns the loss (a 0-d
        tensor on the device). With ``GRAD_ACCUM_STEPS`` the batch runs as
        that many microbatches of consecutive rows, their f32 gradients
        summed and scaled by 1/N."""
        accum = self._grad_accum_steps()
        if accum <= 1:
            loss = self.forward_loss(self._to_device(batch))
            loss.backward()
            self.apply_gradients()
            return loss.detach()
        rows = len(next(iter(batch.values()))) // accum
        total, summed = None, None
        for i in range(accum):
            micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss = self.forward_loss(self._to_device(micro), micro=i)
            loss.backward()
            grads = self._collect_grads()
            if summed is None:
                summed, total = grads, loss.detach()
            else:
                torch._foreach_add_([summed[n] for n in grads], list(grads.values()))
                total = total + loss.detach()
        inv = 1.0 / accum
        torch._foreach_mul_(list(summed.values()), inv)
        self.apply_gradients(summed)
        return total * inv

    def _train_epoch(self, epoch: int) -> float:
        """One epoch of steps over the epoch-seeded shuffle. ``SAVE_EVERY_STEPS``
        refreshes ``last_ckp`` inside the epoch, tagged with the step in the
        epoch; a run resumed from such a checkpoint skips the batches it
        already trained."""
        c = self.config
        n_steps = num_batches(len(self.train_data), c.TRAIN_BATCH_SIZE, drop_last=True)
        batches = batch_iterator(self.train_data, c.TRAIN_BATCH_SIZE, shuffle=True,
                                 seed=c.get("SEED", 13) + epoch, drop_last=True)
        save_every = int(c.get("SAVE_EVERY_STEPS", 0) or 0)
        skip = int(getattr(self, "_resume_step_in_epoch", 0) or 0)
        self._resume_step_in_epoch = 0  # only the interrupted epoch skips
        if skip:
            log.info(f"--TRAINING--|Epoch: {epoch}| fast-forwarding {skip} already-trained "
                     "batches from the mid-epoch checkpoint")
        total, it = 0.0, 0
        t0 = time.perf_counter()
        for batch, _ in batches:
            if it < skip:
                it += 1
                continue
            total += float(self.train_step(batch))
            it += 1
            done = it - skip
            if done == 1 or it % 20 == 0 or it == n_steps:
                elapsed = time.perf_counter() - t0
                log.info(f"--TRAINING--|Epoch: {epoch}| Step: {it}/{n_steps} "
                         f"| Loss: {round(total / done, 2)} | {1e3 * elapsed / done:.1f} ms/step, "
                         f"{done * c.TRAIN_BATCH_SIZE / elapsed:.1f} samples/s")
            if save_every and c.get("SAVE") and it % save_every == 0:
                # tagged even at it == n_steps: the epoch's eval and counter
                # have not run yet, so a resume skips every batch of it
                self._step_in_epoch = it
                self._save_checkpoint("last")
                self._step_in_epoch = 0
        return total / max(it - skip, 1)

    # -- VIT_CACHE ------------------------------------------------------------------

    def _maybe_attach_vit_cache(self, dataset_attrs) -> None:
        """``VIT_CACHE: true``: encode each unique image once with the frozen
        ViT and feed the encodings as a batch input (``data/vit_cache.py``).
        Exact (the ViT has no dropout) while the ViT cannot change under the
        cache: always in eval and predict; in training only when the model
        freezes its ViT (the LaTr family, not PreSTU) and no LoRA adapter
        targets it. Otherwise it warns and falls back."""
        c = self.config
        if not c.get("VIT_CACHE"):
            return
        if getattr(self.model_config, "vit", None) is None:
            log.warning(f"(!) VIT_CACHE ignored: {c.MODEL_CLASS} has no image encoder")
            return
        if self.mode == "train":
            if not getattr(self.model_config, "freeze_vit", False):
                log.warning(f"(!) VIT_CACHE ignored in train mode: {c.MODEL_CLASS} trains its "
                            "ViT, the cache would go stale every step")
                return
            if any(n.startswith("vit.") for n in (self.state.lora or {})):
                log.warning("(!) VIT_CACHE ignored: LoRA adapters target the ViT")
                return
        self._ensure_params()
        model = self.model

        @torch.no_grad()  # not inference mode: training saves the encodings for backward
        def encode(pixels):
            model.eval()
            return model.encode_image(torch.from_numpy(np.asarray(pixels)).to(self.device))

        batch_size = int(c.get("VIT_CACHE_BATCH", 0) or c.EVAL_BATCH_SIZE)
        max_bytes = int(float(c.get("VIT_CACHE_MAX_GB", 8)) * 2**30)
        for attr in dataset_attrs:
            dataset = getattr(self, attr, None)
            if dataset is None:
                continue
            t0 = time.perf_counter()
            ok, reason = attach_vit_cache(dataset, encode, batch_size, max_bytes)
            log.info(f"# VIT_CACHE {attr}: " + (f"{reason} ({time.perf_counter() - t0:.1f}s)"
                                                 if ok else f"skipped: {reason}"))

    def infer(self, dataset, batch_size: int, max_length: int,
              return_scores: bool = False) -> List[str]:
        """Decode answer strings for every dataset row, in batches of
        ``batch_size`` (the last one padded), or through the pool decode
        (``EVAL_CONTINUOUS``). ``return_scores=True`` returns ``(answers,
        scores)``: each answer's mean emitted-token log-probability. The
        module's weights are the compute-dtype copies of the masters, the JAX
        executor's ``_inference_params``."""
        return self.infer_async(dataset, batch_size, max_length, return_scores)()

    def infer_async(self, dataset, batch_size: int, max_length: int,
                    return_scores: bool = False, decoder=None):
        """Start :meth:`infer` and return a zero-argument ``resolve()`` that
        gives its result. With ``decoder`` (a ``serving.graphs.GraphDecoder``
        for this batch size) every batch moves to the device and its encode
        is launched here, and ``resolve`` replays the decoder's captured
        decode and reads the rows back; the serving engine calls this from
        its dispatcher thread and resolves on its resolver thread. Without
        one, ``resolve`` runs the eager generate, a batch at a time."""
        self._ensure_params()
        self.model.eval()
        batches = batch_iterator(dataset, batch_size, pad_final=True)
        if decoder is not None:
            pending = [(decoder.start(self._device_batch(b)), n_valid) for b, n_valid in batches]
        elif self._use_pool_decode():
            return lambda: self._answers(
                *self._infer_pool(dataset, batch_size, max_length, return_scores), return_scores)
        else:
            generate = self._get_generate_fn(max_length, return_scores)
            # a generator: each batch moves to the device when resolve reaches it
            pending = ((functools.partial(generate, self._device_batch(b)), n_valid)
                       for b, n_valid in batches)

        def resolve():
            rows, scores = [], []
            for finish, n_valid in pending:
                out = finish()
                ids = out[0] if return_scores else out
                rows.extend(ids[:n_valid].tolist())
                if return_scores:
                    scores.extend(out[1][:n_valid].double().tolist())
            return self._answers(rows, scores, return_scores)

        return resolve

    def _answers(self, rows, scores, return_scores: bool):
        answers = self._decode_rows(rows)
        return (answers, scores) if return_scores else answers

    def _device_batch(self, batch: dict) -> dict:
        return to_device_batch(batch, self.device, self._batch_keys(self.model_class.BATCH_KEYS))

    def _get_generate_fn(self, max_length: int, with_scores: bool = False):
        key = (max_length, with_scores)
        if key not in self._generate_fns:
            self._generate_fns[key] = self._build_generate_fn(max_length, with_scores)
        return self._generate_fns[key]

    def _decodes_greedy(self) -> bool:
        """Whether ``infer``'s batch decode gives greedy's rows (what the
        serving graphs capture): not under ``SAMPLE``; ``SPEC_DECODE``
        verifies greedy's tokens."""
        return not self.config.get("SAMPLE")

    def _build_generate_fn(self, max_length: int, with_scores: bool = False):
        """The generate ``infer`` decodes with: sampled (``SAMPLE``), verified
        by speculative windows (``SPEC_DECODE``, the stock T5 decoders), else
        greedy over the model's rows (``models.generate.build_generate_fn``)."""
        c = self.config
        if c.get("SAMPLE"):
            if c.get("SPEC_DECODE"):
                log.warning("(!) SAMPLE and SPEC_DECODE both set: sampling wins (speculative "
                            "verification is greedy-only)")
            seed = int(c.get("SEED", 13))
            sampled = make_sample_generate_fn(
                self.model, max_length, temperature=float(c.get("TEMPERATURE", 1.0)),
                top_k=int(c.get("TOP_K", 0) or 0), top_p=float(c.get("TOP_P", 1.0)), seed=seed,
                with_scores=with_scores)
            # a per-call counter: repeated calls draw fresh noise, one process
            # stays reproducible from SEED
            calls = itertools.count()
            return lambda batch: sampled(batch, sample_generator(seed, next(calls), self.device))
        spec_k = int(c.get("SPEC_DECODE", 0) or 0)
        if spec_k > 1:
            if getattr(type(self.model), "spec_decode_supported", False):
                return make_speculative_generate_fn(self.model, max_length, spec_k, with_scores)
            log.warning(f"(!) SPEC_DECODE={spec_k} ignored: {type(self.model).__name__} uses a "
                        "custom decoder cache")
        return build_generate_fn(self.model, max_length, with_scores)

    # -- slot-refill offline decode (EVAL_CONTINUOUS) --------------------------------

    def _use_pool_decode(self) -> bool:
        """``EVAL_CONTINUOUS: true`` routes ``infer`` through the slot-refill
        pool decode (``decode/pool.py``): the same answers, fewer decode steps
        when answer lengths vary. Greedy only: a ``SAMPLE``, ``SPEC_DECODE``
        or beam config logs why and keeps the batch decode."""
        c = self.config
        if not c.get("EVAL_CONTINUOUS"):
            return False
        reason = None
        if c.get("SAMPLE") or int(c.get("SPEC_DECODE", 0) or 0) > 1:
            reason = "SAMPLE/SPEC_DECODE configs use the batch decode"
        elif not (c.get("isgreedy", True) or int(c.get("num_beam", 1) or 1) <= 1):
            reason = "beam search uses the batch decode"
        if reason is not None:
            if not getattr(self, "_warned_pool", False):
                log.warning(f"(!) EVAL_CONTINUOUS ignored: {reason}")
                self._warned_pool = True
            return False
        return True

    @torch.inference_mode()
    def _infer_pool(self, dataset, batch_size: int, max_length: int, return_scores: bool):
        """Rows through the pool decode: each batch is prefilled (the batch
        path's encode), its rows kept on the device as a pool of up to
        ``EVAL_POOL_ROWS`` (at least a batch), and each pool decoded by
        ``EVAL_SLOTS`` (default: the batch size) refilling slots. Returns
        (token rows, scores)."""
        model = self.model
        num_slots = int(self.config.get("EVAL_SLOTS", 0) or batch_size)
        pool_max = max(int(self.config.get("EVAL_POOL_ROWS", 128)), batch_size)
        ncomp = int(getattr(type(model), "decode_components", 1))
        bos, eos, pad = decode_token_ids(model)
        rows, scores, caches, masks = [], [], [], []
        pooled, full_bias = 0, None

        def flush():
            nonlocal caches, masks, pooled
            if not pooled:
                return
            cache = {n: torch.cat([c[n] for c in caches], dim=1) for n in CACHE_KEYS}
            enc_mask = torch.cat(masks, dim=0)
            bias = full_bias

            def step_k(tokens, cache, pos, enc_mask):
                return model.decode_step_k(tokens, cache, pos, bias, enc_mask)

            out = pool_greedy_decode(step_k, cache, enc_mask, num_slots, max_length, bos, eos,
                                     pad, num_components=ncomp, with_scores=return_scores)
            rows.extend((out[0] if return_scores else out).tolist())
            if return_scores:
                scores.extend(out[1].double().tolist())
            caches, masks, pooled = [], [], 0

        for batch, n_valid in batch_iterator(dataset, batch_size, pad_final=True):
            cache, full_bias, enc_mask = model.encode_for_generate(self._device_batch(batch),
                                                                   max_length)
            caches.append({n: cache[n][:, :n_valid] for n in CACHE_KEYS})  # drop the pad rows
            masks.append(enc_mask[:n_valid])
            pooled += n_valid
            if pooled >= pool_max:
                flush()
        flush()
        return rows, scores

    def _decode_rows(self, rows) -> List[str]:
        """Cut [start, ..., eos] to the tokens between, then detokenize with
        the backbone tokenizer."""
        return decode_rows(self.tokenizer, rows)
