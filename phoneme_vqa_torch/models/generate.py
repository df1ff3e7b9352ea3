"""Greedy generation over a fusion model (counterpart of
``phoneme_vqa_tpu/models/generate.py: make_generate_fn``): encode once,
then the KV-cached decode loop of :func:`decode.greedy.greedy_decode`."""

from __future__ import annotations

import torch

from ..decode.greedy import greedy_decode


def decode_token_ids(model):
    """(bos, eos, pad) a model decodes with: its answer vocabulary's
    (``decode_token_ids``, the custom decoders) or the T5 backbone's."""
    ids = getattr(model, "decode_token_ids", None)
    if ids is None:
        t5c = model.cfg.t5
        ids = (t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id)
    return tuple(int(i) for i in ids)


def make_generate_fn(model, max_length: int, with_scores: bool = False):
    bos, eos, pad = decode_token_ids(model)

    @torch.inference_mode()
    def generate(batch):
        """``batch``: dict of tensors on the model's device. Runs the model
        in eval mode (no dropout) and leaves its mode as it found it."""
        training = model.training
        model.eval()
        try:
            cache, full_bias, enc_mask = model.encode_for_generate(batch, max_length)

            def step(tokens, cache, i):
                return model.decode_step(tokens, cache, i, full_bias, enc_mask)

            return greedy_decode(
                step, cache, enc_mask.shape[0], max_length, bos, eos, pad,
                device=enc_mask.device, with_scores=with_scores,
            )
        finally:
            model.train(training)

    return generate
