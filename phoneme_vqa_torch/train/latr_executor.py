"""LaTr executor (counterpart of ``phoneme_vqa_tpu/train/latr_executor.py``).

The generic machinery (train step, greedy generate, metric eval,
checkpoints) lives in :class:`BaseExecutor`; this class binds the LaTr
family's feature stores and training properties, and featurizes with the
model class's ``DATASET`` (LaTr's, or PreSTU's for that family). QA CSVs
are read with the standard library (``data.synthetic.read_qa_csv``): the
card machine has no pandas.
"""

from __future__ import annotations

import os

import torch

from ..data import feature_cache
from ..data.adapters import textlayout_ocr_adapt
from ..data.loader import num_batches
from ..data.synthetic import read_qa_csv
from ..models import latr as latr_mod
from ..models.hf_import import ImportReport, import_latr_weights
from ..tokenizers.backbone import load_backbone_tokenizer
from ..utils.logger import get_logger
from ..utils.registry import EXECUTORS, MODEL_CONFIGS
from .base_executor import BaseExecutor
from .checkpoint import CheckpointManager
from .optim import (
    build_optimizer,
    epoch_decay_schedule,
    mu_dtype_from_config,
    optimizer_extras_from_config,
    optimizer_kind_from_config,
    schedule_from_config,
)
from .state import TrainState, bind_params, tree_map

log = get_logger(__name__)


@EXECUTORS.register("LaTr_Executor")
class LaTrExecutor(BaseExecutor):
    REQUIRED_TRAIN_KEYS = BaseExecutor.REQUIRED_TRAIN_KEYS + (
        "ocr_path", "base_img_path", "max_ocr_element", "max_ocr_length",
        "backbone_name",
    )

    # -- data ------------------------------------------------------------------

    def _make_dataset(self, qa_rows, ocr_store):
        c = self.config
        return self.model_class.DATASET(
            qa_rows, ocr_store, self.tokenizer, c.base_img_path,
            max_ocr_element=c.max_ocr_element, max_ocr_length=c.max_ocr_length,
            max_input_length=c.max_q_length, max_output_length=c.max_a_length,
            answer_encoder=self._answer_encoder(), **self._feature_cache_args(),
        ).dataset

    def _feature_cache_args(self) -> dict:
        """``FEATURE_CACHE: <dir>`` -> the dataset's cache arguments (none in
        serve mode: its batches are per-request). The tag names the answer
        tokenizer of the customized and phoneme executors, whose vocabulary
        the rows' content does not capture."""
        cache_dir = self.config.get("FEATURE_CACHE") or None
        if self.mode == "serve":
            cache_dir = None
        tok = getattr(self, "decode_tokenizer", None)
        return {"cache_dir": cache_dir,
                "cache_tag": feature_cache.tokenizer_tag(tok) if tok is not None else ""}

    def _answer_encoder(self):
        """None: answers are encoded by the backbone tokenizer (the
        customized and phoneme executors encode them with their own)."""
        return None

    def _create_tokenizers(self):
        self.tokenizer = load_backbone_tokenizer(
            self.config.backbone_name, vocab_size=self.config.get("t5_vocab_size", 36096)
        )

    def _adapt_frames(self) -> tuple:
        """The feature stores ``_make_dataset`` takes after the QA rows."""
        return (textlayout_ocr_adapt(self.config.ocr_path,
                                     cache_dir=self.config.get("FEATURE_CACHE") or None),)

    def _prepare_decode_tokenizer(self, train_rows, val_rows):
        """The custom decoders' executors build their answer tokenizer here."""

    def _create_data_utils(self):
        self._create_tokenizers()
        train_rows = read_qa_csv(self.config.qa_train_path)
        val_rows = read_qa_csv(self.config.qa_val_path)
        self.val_answer = [str(r["answer"]) for r in val_rows]
        self._prepare_decode_tokenizer(train_rows, val_rows)
        stores = self._adapt_frames()
        log.info("# Creating Datasets")
        self.train_data = self._make_dataset(train_rows, *stores)
        self.val_data = self._make_dataset(val_rows, *stores)

    def _init_eval_predict_mode(self):
        self._create_tokenizers()
        stores = self._adapt_frames()
        if self.mode == "eval":
            log.info("###Load eval data ...")
            rows = read_qa_csv(self.config.qa_val_path)
            self.val_answer = [str(r["answer"]) for r in rows]
            self._prepare_decode_tokenizer(rows, rows)
            self.val_data = self._make_dataset(rows, *stores)
        else:
            log.info("###Load predict data ...")
            rows = read_qa_csv(self.config.qa_predict_path)
            self.predict_answer = [str(r["answer"]) for r in rows]
            self._prepare_decode_tokenizer(rows, rows)
            self.predict_data = self._make_dataset(rows, *stores)

    def _init_serve_mode(self):
        """The tokenizers only: requests are featurized batch by batch by the
        serving engine, against :attr:`serve_frames`. A BPE answer tokenizer
        must load its saved vocabulary: serving has no answers to train one
        on."""
        self._create_tokenizers()
        if "BPE" in str(self.config.get("DecodeTokenizer", "")):
            vocab_path = self.config.get("vocab_save_path", "bpevocab.json")
            if not os.path.isfile(vocab_path):
                raise FileNotFoundError(f"serve mode requires the trained BPE vocab at "
                                        f"{vocab_path!r} (run --mode train first)")
        self._prepare_decode_tokenizer([], [])
        self._serve_frames = None

    @property
    def serve_frames(self) -> tuple:
        """(OCR store, object store or None), adapted at first access."""
        if getattr(self, "_serve_frames", None) is None:
            stores = self._adapt_frames()
            self._serve_frames = (stores[0], stores[1] if len(stores) > 1 else None)
        return self._serve_frames

    # -- model -----------------------------------------------------------------

    def _build_model(self):
        """The model on the meta device, then on ``self.device`` with seeded
        f32 random values (``SEED``): the masters, and through them the
        compute weights. In serve mode the model stays on the meta device
        (``BaseExecutor._ensure_params``)."""
        log.info("# Building model architecture ...")
        self.model_config = self._build_model_config(
            MODEL_CONFIGS.get(self.config.MODEL_MOD_CONFIG_CLASS)())
        with torch.device("meta"):
            self.model = self.model_class(self.model_config, device="meta")
        self.ckpt = CheckpointManager(self.config.SAVE_PATH)
        n = sum(p.numel() for p in self.model.parameters())
        log.info(f"# Model parameters: {n / 1e6:.1f}M")
        if self._defer_params_init():
            self._abstract_params = True
            self.state = TrainState(params={}, opt_state=None)
            return
        self._materialize()
        self.state = TrainState(params=bind_params(self.model, self._random_params()),
                                opt_state=None)
        self._maybe_import_pretrained()
        self._maybe_parallelize()

    def _defer_params_init(self) -> bool:
        """Serve mode leaves the model on the meta device (a checkpoint
        restore fills it); not so when ``pretrained_weights_path`` imports
        into the random init."""
        return self.mode == "serve" and not self.config.get("pretrained_weights_path")

    def _maybe_import_pretrained(self):
        """``pretrained_weights_path``: a directory with ``t5/`` and ``vit/``
        HF checkpoints (``models/hf_import.py``) imported into the f32
        masters, before the compute weights are cast from them; parameters
        no key fills keep their init."""
        path = self.config.get("pretrained_weights_path")
        if path:
            self.import_report = ImportReport()
            params = import_latr_weights(self.state.params, path, report=self.import_report)
            self.state.params = bind_params(self.model, params)
            log.info(f"# Imported pretrained weights from {path}")

    def _random_params(self):
        generator = torch.Generator(device=self.device).manual_seed(self.config.get("SEED", 13))
        return latr_mod.random_params(self.model, generator)

    def _build_model_config(self, cfg_builder):
        return cfg_builder.build(self.config)

    # -- training ----------------------------------------------------------------

    def _make_optimizer(self, schedule):
        """The optimizer the config names (``OPTIMIZER``, ``OPT_MU_DTYPE``,
        ``GRAD_CLIP``, ``WEIGHT_DECAY``) over ``schedule``; adafactor keeps
        the Linear and Conv weights' statistics in flax's layout."""
        c = self.config
        kernels = [f"{name}.weight" for name, m in self.model.named_modules()
                   if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
        return build_optimizer(
            schedule, betas=tuple(c.BETAS), mu_dtype=mu_dtype_from_config(c),
            kind=optimizer_kind_from_config(c), freeze_predicate=self._freeze_predicate(),
            kernels=kernels, **optimizer_extras_from_config(c),
        )

    def _default_schedule(self, steps_per_epoch: int):
        """The family's LR schedule when ``LR_SCHEDULE`` is unset."""
        return epoch_decay_schedule(self.config.LR, steps_per_epoch)

    def _init_training_properties(self):
        c = self.config
        steps_per_epoch = num_batches(len(self.train_data), c.TRAIN_BATCH_SIZE, drop_last=True)
        schedule = schedule_from_config(c, self._default_schedule(steps_per_epoch),
                                        steps_per_epoch)
        self._lr_schedule = schedule  # metrics.jsonl logs the live LR
        self._grad_accum_steps()  # a value that does not divide the batch raises here
        self._maybe_enable_lora()
        self.tx = self._wrap_optimizer(self._make_optimizer(schedule))
        self.state.opt_state = self.tx.init(self._opt_params())
        if self._ema_decay():
            self.state.ema_params = tree_map(lambda t: t.detach().clone(), self._ckpt_params())
        self._bind_optimizer()
        self._maybe_resume()
