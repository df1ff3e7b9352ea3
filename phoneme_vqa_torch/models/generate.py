"""Generation over a fusion model (counterpart of
``phoneme_vqa_tpu/models/generate.py``): encode once, then one of the
KV-cached decode loops of ``decode/``:

* greedy (:func:`make_generate_fn`), or over component tuples for a model
  that decodes them (``decode_components`` > 1: the phoneme triple decoder,
  :func:`make_multi_head_generate_fn`);
* beam search (:func:`make_beam_generate_fn`,
  :func:`make_multi_head_beam_generate_fn`): the cache and the encoder mask
  expanded to B·K rows after the encode;
* sampling (:func:`make_sample_generate_fn`);
* speculative greedy with prompt-lookup drafts
  (:func:`make_speculative_generate_fn`).

:func:`build_generate_fn` picks greedy or beam by the model, as the
executors do.
"""

from __future__ import annotations

import torch

from ..decode.beam import beam_decode, expand_to_beams, multi_head_beam_decode
from ..decode.greedy import greedy_decode, multi_head_greedy_decode
from ..decode.sample import sample_decode
from ..decode.speculative import make_prompt_lookup_draft, speculative_greedy_decode

# (ids key, mask key) pairs speculative drafts copy from, concatenated; an
# explicit ``spec_source_ids`` key in the batch replaces the others
SPEC_SOURCES = (
    ("spec_source_ids", "spec_source_mask"),
    ("tokenized_ocr", "ocr_attention_mask"),
    ("input_ids", "src_attention_mask"),
)


def decode_token_ids(model):
    """(bos, eos, pad) a model decodes with: its answer vocabulary's
    (``decode_token_ids``, the custom decoders) or the T5 backbone's."""
    ids = getattr(model, "decode_token_ids", None)
    if ids is None:
        t5c = model.cfg.t5
        ids = (t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id)
    return tuple(int(i) for i in ids)


def _generate_with(model, max_length: int, decode, num_beams: int = 1, step_k: bool = False):
    """``generate(batch, *args)`` running ``decode(step, cache, enc_mask,
    batch, *args)`` after the model's encode, in eval mode (no dropout); it
    leaves the model's mode as it found it. ``num_beams`` > 1 expands the
    cache and the encoder mask to B·K rows first; ``step_k`` hands
    ``decode`` the model's K-token step at per-row positions in place of its
    one-token step. ``batch``: dict of tensors on the model's device."""

    @torch.inference_mode()
    def generate(batch, *args):
        training = model.training
        model.eval()
        try:
            cache, full_bias, enc_mask = model.encode_for_generate(batch, max_length)
            if num_beams > 1:
                cache, enc_mask = expand_to_beams(cache, num_beams), expand_to_beams(
                    enc_mask, num_beams)
            method = model.decode_step_k if step_k else model.decode_step

            def step(tokens, cache, i):
                return method(tokens, cache, i, full_bias, enc_mask)

            return decode(step, cache, enc_mask, batch, *args)
        finally:
            model.train(training)

    return generate


def make_generate_fn(model, max_length: int, with_scores: bool = False):
    """(B, max_length) token rows, from the model's (bos, eos, pad)."""
    bos, eos, pad = decode_token_ids(model)
    return _generate_with(model, max_length, lambda step, cache, enc_mask, _: greedy_decode(
        step, cache, enc_mask.shape[0], max_length, bos, eos, pad, device=enc_mask.device,
        with_scores=with_scores))


def make_multi_head_generate_fn(model, max_length: int, num_components: int, bos_id: int,
                                eos_id: int, pad_id: int, stop_component: int = 0,
                                with_scores: bool = False):
    """(B, max_length, num_components) rows of component ids (phoneme
    triples); a row stops at its ``stop_component`` EOS."""
    return _generate_with(model, max_length, lambda step, cache, enc_mask, _: (
        multi_head_greedy_decode(step, cache, enc_mask.shape[0], max_length, num_components,
                                 bos_id, eos_id, pad_id, device=enc_mask.device,
                                 stop_component=stop_component, with_scores=with_scores)))


def make_beam_generate_fn(model, max_length: int, num_beams: int, with_scores: bool = False):
    """Beam search: the best of ``num_beams`` hypotheses a row, (B,
    max_length) token rows."""
    bos, eos, pad = decode_token_ids(model)
    return _generate_with(model, max_length, lambda step, cache, enc_mask, _: beam_decode(
        step, cache, enc_mask.shape[0] // num_beams, num_beams, max_length, bos, eos, pad,
        device=enc_mask.device, with_scores=with_scores), num_beams=num_beams)


def make_multi_head_beam_generate_fn(model, max_length: int, num_beams: int, bos_id: int,
                                     eos_id: int, pad_id: int, stop_component: int = 0,
                                     with_scores: bool = False):
    """Beam search over (onset, rhyme, tone) triples: (B, max_length, 3)."""
    return _generate_with(model, max_length, lambda step, cache, enc_mask, _: (
        multi_head_beam_decode(step, cache, enc_mask.shape[0] // num_beams, num_beams,
                               max_length, bos_id, eos_id, pad_id, device=enc_mask.device,
                               stop_component=stop_component, with_scores=with_scores)),
        num_beams=num_beams)


def make_sample_generate_fn(model, max_length: int, temperature: float = 1.0, top_k: int = 0,
                            top_p: float = 1.0, seed: int = 0, with_scores: bool = False):
    """Sampled (B, max_length) token rows (``SAMPLE`` with ``TEMPERATURE``,
    ``TOP_K``, ``TOP_P``): ``generate(batch, generator=None)``, where
    ``generator`` is the call's stream (``decode.sample.sample_generator``;
    ``None``: one seeded from ``seed``, the same draws every call).
    Temperature 0 or top-k 1 is greedy."""
    bos, eos, pad = decode_token_ids(model)
    return _generate_with(model, max_length, lambda step, cache, enc_mask, _, generator=None: (
        sample_decode(step, cache, enc_mask.shape[0], max_length, bos, eos, pad,
                      device=enc_mask.device, seed=seed, temperature=temperature, top_k=top_k,
                      top_p=top_p, generator=generator, with_scores=with_scores)))


def speculative_source(batch):
    """(ids, mask) the drafts copy from: ``spec_source_ids`` when the batch
    has it, else its OCR ids ++ question ids (those it has)."""
    keys = SPEC_SOURCES[:1] if SPEC_SOURCES[0][0] in batch else SPEC_SOURCES[1:]
    parts = [(batch[k], batch.get(m)) for k, m in keys if k in batch]
    if not parts:
        raise ValueError("SPEC_DECODE needs source token ids in the batch "
                         f"(one of {[k for k, _ in SPEC_SOURCES]})")
    return (torch.cat([p for p, _ in parts], dim=1),
            torch.cat([torch.ones_like(p) if m is None else m for p, m in parts], dim=1))


def make_speculative_generate_fn(model, max_length: int, spec_k: int,
                                 with_scores: bool = False):
    """Greedy generation verified ``spec_k`` tokens a trip with prompt-lookup
    drafts (``SPEC_DECODE: K``): token for token greedy's rows. Needs a
    model whose decoder is the stock T5 one (``spec_decode_supported``)."""
    if not getattr(type(model), "spec_decode_supported", False):
        raise ValueError(f"{type(model).__name__} uses a custom decoder cache: SPEC_DECODE "
                         "supports the stock T5-decoder families")
    bos, eos, pad = decode_token_ids(model)

    def decode(step_k, cache, enc_mask, batch):
        source, mask = speculative_source(batch)
        draft = make_prompt_lookup_draft(source, spec_k - 1, pad, mask)
        return speculative_greedy_decode(step_k, draft, cache, enc_mask.shape[0], max_length,
                                         spec_k, bos, eos, pad, device=enc_mask.device,
                                         with_scores=with_scores)

    return _generate_with(model, max_length, decode, step_k=True)


def build_generate_fn(model, max_length: int, with_scores: bool = False, num_beams: int = 1):
    """The generate a model decodes with, chosen by its ``decode_components``
    (1 when it has none) and ``num_beams``: greedy or beam search, over token
    rows or over component rows stopped by the onset (component 0)."""
    components = int(getattr(model, "decode_components", 1))
    bos, eos, pad = decode_token_ids(model)
    if num_beams > 1:
        if components == 1:
            return make_beam_generate_fn(model, max_length, num_beams, with_scores)
        return make_multi_head_beam_generate_fn(model, max_length, num_beams, bos, eos, pad,
                                                with_scores=with_scores)
    if components == 1:
        return make_generate_fn(model, max_length, with_scores)
    return make_multi_head_generate_fn(model, max_length, components, bos, eos, pad,
                                       with_scores=with_scores)
