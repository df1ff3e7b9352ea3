"""Greedy generation over a fusion model (counterpart of
``phoneme_vqa_tpu/models/generate.py: make_generate_fn`` and
``make_multi_head_generate_fn``): encode once, then the KV-cached decode
loop of :func:`decode.greedy.greedy_decode`, or of
:func:`decode.greedy.multi_head_greedy_decode` for a model that decodes
component tuples (``decode_components`` > 1: the phoneme triple decoder).
:func:`build_generate_fn` picks by the model."""

from __future__ import annotations

import torch

from ..decode.greedy import greedy_decode, multi_head_greedy_decode


def decode_token_ids(model):
    """(bos, eos, pad) a model decodes with: its answer vocabulary's
    (``decode_token_ids``, the custom decoders) or the T5 backbone's."""
    ids = getattr(model, "decode_token_ids", None)
    if ids is None:
        t5c = model.cfg.t5
        ids = (t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id)
    return tuple(int(i) for i in ids)


def _generate_with(model, max_length: int, decode):
    """``generate(batch)`` running ``decode(step, cache, enc_mask)`` after the
    model's encode, in eval mode (no dropout); it leaves the model's mode as
    it found it. ``batch``: dict of tensors on the model's device."""

    @torch.inference_mode()
    def generate(batch):
        training = model.training
        model.eval()
        try:
            cache, full_bias, enc_mask = model.encode_for_generate(batch, max_length)

            def step(tokens, cache, i):
                return model.decode_step(tokens, cache, i, full_bias, enc_mask)

            return decode(step, cache, enc_mask)
        finally:
            model.train(training)

    return generate


def make_generate_fn(model, max_length: int, with_scores: bool = False):
    """(B, max_length) token rows, from the model's (bos, eos, pad)."""
    bos, eos, pad = decode_token_ids(model)
    return _generate_with(model, max_length, lambda step, cache, enc_mask: greedy_decode(
        step, cache, enc_mask.shape[0], max_length, bos, eos, pad, device=enc_mask.device,
        with_scores=with_scores))


def make_multi_head_generate_fn(model, max_length: int, num_components: int, bos_id: int,
                                eos_id: int, pad_id: int, stop_component: int = 0,
                                with_scores: bool = False):
    """(B, max_length, num_components) rows of component ids (phoneme
    triples); a row stops at its ``stop_component`` EOS."""
    return _generate_with(model, max_length, lambda step, cache, enc_mask: (
        multi_head_greedy_decode(step, cache, enc_mask.shape[0], max_length, num_components,
                                 bos_id, eos_id, pad_id, device=enc_mask.device,
                                 stop_component=stop_component, with_scores=with_scores)))


def build_generate_fn(model, max_length: int, with_scores: bool = False):
    """The greedy generate a model decodes with, chosen by its
    ``decode_components`` (1 when it has none): token rows, or component
    rows stopped by the onset (component 0)."""
    components = int(getattr(model, "decode_components", 1))
    if components == 1:
        return make_generate_fn(model, max_length, with_scores)
    bos, eos, pad = decode_token_ids(model)
    return make_multi_head_generate_fn(model, max_length, components, bos, eos, pad,
                                       with_scores=with_scores)
