"""LaTr executor (counterpart of ``phoneme_vqa_tpu/train/latr_executor.py``).

The generic machinery (train step, greedy generate, metric eval,
checkpoints) lives in :class:`BaseExecutor`; this class binds the LaTr
family's feature stores and training properties, and featurizes with the
model class's ``DATASET`` (LaTr's, or PreSTU's for that family). QA CSVs
are read with the standard library (``data.synthetic.read_qa_csv``): the
card machine has no pandas.
"""

from __future__ import annotations

import torch

from ..data.adapters import textlayout_ocr_adapt
from ..data.loader import num_batches
from ..data.synthetic import read_qa_csv
from ..models import latr as latr_mod
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
from .state import TrainState, bind_params

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
            answer_encoder=self._answer_encoder(),
        ).dataset

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
        return (textlayout_ocr_adapt(self.config.ocr_path),)

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

    # -- model -----------------------------------------------------------------

    def _build_model(self):
        """The model on the meta device, then on ``self.device`` with seeded
        f32 random values (``SEED``): the masters, and through them the
        compute weights."""
        log.info("# Building model architecture ...")
        self.model_config = self._build_model_config(
            MODEL_CONFIGS.get(self.config.MODEL_MOD_CONFIG_CLASS)())
        with torch.device("meta"):
            model = self.model_class(self.model_config, device="meta")
        self.model = model.to_empty(device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(self.config.get("SEED", 13))
        params = bind_params(self.model, latr_mod.random_params(self.model, generator))
        n = sum(p.numel() for p in params.values())
        log.info(f"# Model parameters: {n / 1e6:.1f}M")
        self.state = TrainState(params=params, opt_state=None)
        self.ckpt = CheckpointManager(self.config.SAVE_PATH)

    def _build_model_config(self, cfg_builder):
        return cfg_builder.build(self.config)

    # -- training ----------------------------------------------------------------

    def _default_schedule(self, steps_per_epoch: int):
        """The family's LR schedule when ``LR_SCHEDULE`` is unset."""
        return epoch_decay_schedule(self.config.LR, steps_per_epoch)

    def _init_training_properties(self):
        c = self.config
        steps_per_epoch = num_batches(len(self.train_data), c.TRAIN_BATCH_SIZE, drop_last=True)
        schedule = schedule_from_config(c, self._default_schedule(steps_per_epoch),
                                        steps_per_epoch)
        self._lr_schedule = schedule  # metrics.jsonl logs the live LR
        self.tx = build_optimizer(
            schedule, betas=tuple(c.BETAS), mu_dtype=mu_dtype_from_config(c),
            kind=optimizer_kind_from_config(c), freeze_predicate=self._freeze_predicate(),
            **optimizer_extras_from_config(c),
        )
        self.state = TrainState.create(self.state.params, self.tx)
        self._bind_optimizer()
        self._maybe_resume()
