"""Base executor: train / eval / predict (counterpart of
``phoneme_vqa_tpu/train/base_executor.py``, the parts the LaTr path uses).

* the constructor branches on mode; ``run()`` dispatches to ``train``,
  ``evaluate`` or ``predict``;
* train: per-epoch train + metric eval, ``metrics.jsonl``, best/last
  checkpoints on Accuracy (``best_ckp`` seeded on the first epoch),
  ``EARLY_STOP_PATIENCE``, auto-resume from ``last_ckp`` then ``best_ckp``;
* evaluate: load the ``evaltype`` checkpoint, compute the metric dict;
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
"""

from __future__ import annotations

import itertools
import json
import math
import os
import pickle
import time
from typing import Dict, List

import torch

from .. import evaluation
from ..config import Config
from ..data.loader import batch_iterator, num_batches
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
from .state import bind_params, compute_copies, master_grads, refresh_compute_weights_

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


# (key, is it set?, ROADMAP item): JAX knobs the port does not have yet
UNPORTED = (
    ("LORA_RANK", lambda v: bool(v), "A12"),
    ("EMA_DECAY", lambda v: bool(v), "A12"),
    ("GRAD_ACCUM_STEPS", lambda v: int(v or 1) > 1, "A12"),
    ("SCAN_LAYERS", lambda v: bool(v), "A12"),
    ("REMAT", lambda v: bool(v), "A12"),
    ("VIT_CACHE", lambda v: bool(v), "A12"),
    ("FEATURE_CACHE", lambda v: bool(v), "A12"),
    ("SAVE_EVERY_STEPS", lambda v: bool(v), "A12"),
    ("PROFILE_DIR", lambda v: bool(v), "A12"),
    ("DEBUG_NANS", lambda v: bool(v), "A12"),
    ("NUMWORKERS", lambda v: bool(v), "A12"),
    ("pretrained_weights_path", lambda v: bool(v), "A13"),
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
        scores = self._evaluate_metrics()
        log.info("\t#EVALUATION:\n")
        log.info(scores)
        return scores

    def predict(self):
        log.info("###Predict Mode###")
        self._load_trained_checkpoint(self.predicttype)
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

    def _ckpt_tree(self) -> dict:
        return {
            "params": self.state.params,
            "opt_state": self.state.opt_state,
            "step": int(self.state.step),
            "epoch": int(self.state.epoch),
            "step_in_epoch": 0,  # no mid-epoch saves (SAVE_EVERY_STEPS, ROADMAP A12)
            "best_score": float(self.best_score),
        }

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
        checkpoint whose optimizer state does not fit resumes its
        parameters with a fresh optimizer; an unreadable one is skipped with
        a warning, down to a fresh start."""
        for name in ("last", "best"):
            if not self.ckpt.exists(name):
                continue
            try:
                restored = self.ckpt.restore(name, self.device)
                self._check_params(restored["params"])
            except (OSError, EOFError, pickle.UnpicklingError, RuntimeError, ValueError,
                    KeyError) as e:
                log.warning(f"(!) {name}_ckp exists but is unreadable ({e!r}): falling back to "
                            "an older checkpoint / fresh start")
                continue
            self.load_params(restored["params"])
            opt = restored.get("opt_state")
            fresh = self.state.opt_state
            if (isinstance(opt, dict) and set(opt) == set(fresh)
                    and all({n: t.shape for n, t in opt[k].items()}
                            == {n: t.shape for n, t in fresh[k].items()} for k in ("mu", "nu"))):
                self.state.opt_state = opt
                kind = ""
            else:
                kind = "PARAMS ONLY (the optimizer starts fresh) "
            self.state.step = int(restored["step"])
            self.state.epoch = int(restored["epoch"])
            self.best_score = float(restored["best_score"])
            log.info(f"###Resumed {kind}from {name}_ckp (epoch {self.state.epoch})")
            return

    def _load_trained_checkpoint(self, loadtype: str):
        """Eval/predict: the checkpoint's parameters into the model (cast to
        its compute dtype); no optimizer state."""
        restored = self.ckpt.restore(loadtype, self.device)
        self._check_params(restored["params"])
        self.load_params(restored["params"])
        self.best_score = float(restored["best_score"])

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Every parameter by name, in f32 (a checkpoint's masters, or a
        flax tree through ``models.bridge.flax_to_state_dict``), into the
        model and the train state; in train mode the optimizer state starts
        afresh."""
        self.state.params = bind_params(self.model, params)
        if self.mode == "train":
            self.state.opt_state = self.tx.init(self.state.params)
            self._bind_optimizer()

    def _bind_optimizer(self):
        self._trainable = list(self.state.opt_state["mu"])
        self._copies = compute_copies(self.model, self.state.params, self._trainable)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name in self.state.opt_state["mu"])

    # -- train / infer ---------------------------------------------------------

    def _freeze_predicate(self):
        """The model's structural ViT freeze (the reference freezes its ViT
        with ``requires_grad=False``): the ``vit`` parameters take no
        gradient, no optimizer state and no update, so no update rule
        (decoupled weight decay included) moves them."""
        if not getattr(self.model_config, "freeze_vit", False):
            return None
        return lambda name: name.split(".", 1)[0] == "vit"

    def _model_batch(self, batch: dict) -> dict:
        return {k: batch[k] for k in self.model_class.BATCH_KEYS}

    def _to_device(self, batch: dict) -> dict:
        return to_device_batch(batch, self.device, self.model_class.BATCH_KEYS + LABEL_KEYS)

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

    def forward_loss(self, batch) -> torch.Tensor:
        """The train step's forward: training mode, dropout drawn from
        ``(SEED, step)`` (every dropout site of the model, a custom decoder's
        included, draws from ``model.t5.dropout_rng``), the loss of a device
        batch."""
        self.model.train()
        self.model.t5.dropout_rng.reseed(self.config.get("SEED", 13), self.state.step)
        return self._loss_from_batch(batch)

    def apply_gradients(self) -> None:
        """The train step's optimizer: the module's gradients, cast up into
        f32 master gradients, update the masters; the bf16 compute copies
        are refreshed from them and the gradients dropped."""
        grads = master_grads(self.model, self.state.params, self._trainable)
        self.tx.update_(self.state.params, grads, self.state.opt_state)
        refresh_compute_weights_(self._copies)
        self.model.zero_grad(set_to_none=True)
        self.state.step += 1

    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a numpy batch; returns the loss (a 0-d
        tensor on the device)."""
        loss = self.forward_loss(self._to_device(batch))
        loss.backward()
        self.apply_gradients()
        return loss.detach()

    def _train_epoch(self, epoch: int) -> float:
        c = self.config
        n_steps = num_batches(len(self.train_data), c.TRAIN_BATCH_SIZE, drop_last=True)
        batches = batch_iterator(self.train_data, c.TRAIN_BATCH_SIZE, shuffle=True,
                                 seed=c.get("SEED", 13) + epoch, drop_last=True)
        total, it = 0.0, 0
        t0 = time.perf_counter()
        for batch, _ in batches:
            total += float(self.train_step(batch))
            it += 1
            if it == 1 or it % 20 == 0 or it == n_steps:
                elapsed = time.perf_counter() - t0
                log.info(f"--TRAINING--|Epoch: {epoch}| Step: {it}/{n_steps} "
                         f"| Loss: {round(total / it, 2)} | {1e3 * elapsed / it:.1f} ms/step, "
                         f"{it * c.TRAIN_BATCH_SIZE / elapsed:.1f} samples/s")
        return total / max(it, 1)

    def infer(self, dataset, batch_size: int, max_length: int,
              return_scores: bool = False) -> List[str]:
        """Decode answer strings for every dataset row, in batches of
        ``batch_size`` (the last one padded), or through the pool decode
        (``EVAL_CONTINUOUS``). ``return_scores=True`` returns ``(answers,
        scores)``: each answer's mean emitted-token log-probability. The
        module's weights are the compute-dtype copies of the masters, the JAX
        executor's ``_inference_params``."""
        self.model.eval()
        if self._use_pool_decode():
            rows, scores = self._infer_pool(dataset, batch_size, max_length, return_scores)
        else:
            generate = self._get_generate_fn(max_length, return_scores)
            rows, scores = [], []
            for batch, n_valid in batch_iterator(dataset, batch_size, pad_final=True):
                out = generate(self._device_batch(batch))
                ids = out[0] if return_scores else out
                rows.extend(ids[:n_valid].tolist())
                if return_scores:
                    scores.extend(out[1][:n_valid].double().tolist())
        answers = self._decode_rows(rows)
        return (answers, scores) if return_scores else answers

    def _device_batch(self, batch: dict) -> dict:
        return to_device_batch(batch, self.device, self.model_class.BATCH_KEYS)

    def _get_generate_fn(self, max_length: int, with_scores: bool = False):
        key = (max_length, with_scores)
        if key not in self._generate_fns:
            self._generate_fns[key] = self._build_generate_fn(max_length, with_scores)
        return self._generate_fns[key]

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
