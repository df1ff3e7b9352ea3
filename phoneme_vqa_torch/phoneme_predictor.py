"""The standalone phoneme predictor's CLI (the port's counterpart of
``examples/phoneme_predictor.py``).

    python -m phoneme_vqa_torch.phoneme_predictor --sentence "xin chào việt nam" \
        [--vocab-file phoneme_vocab.json] [--model-dim N] [--device cpu] [--seed 0]

Builds ``models/phoneme_predictor.py: MultiTokensPredictor`` at its default
width in f32 with seeded random weights and prints each token's argmax
(onset, rhyme, tone). With no vocabulary file the vocabulary is built from the
sentence itself. ``--model-dim`` is read and, as in the JAX demo, changes
nothing. The weights come from a ``torch.Generator`` seeded by ``--seed``, so
the printed components differ from the JAX demo's ``PRNGKey(0)`` init. It runs
on the card unless ``--device cpu`` is given, and raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .models.phoneme_predictor import (
    MultiTokensPredictor,
    argmax_parts,
    encode_sentence,
    init_weights,
)
from .phonology.vocab import VocabBuilder
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.phoneme_predictor")
    p.add_argument("--sentence", default="xin chào việt nam")
    p.add_argument("--vocab-file", default=None)
    p.add_argument("--model-dim", type=int, default=384)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def predict(sentence: str, vocab=None, model_dim: int = 384, device="cuda",
            seed: int = 0) -> list:
    """One ``Token i: onset: ..., rhyme: ..., tone: ...`` line a token of
    ``sentence``, from the predictor seeded by ``seed`` on ``device``;
    ``vocab`` None builds the vocabulary from the sentence."""
    device = resolve_device(device)
    if vocab is None:
        builder = VocabBuilder([])
        builder.add_text(sentence)
        vocab = builder.vocab
    model = MultiTokensPredictor(vocab, d_model=model_dim, device=device).eval()
    init_weights(model, torch.Generator().manual_seed(seed))
    triples = torch.from_numpy(encode_sentence(vocab, sentence)).to(device)
    with torch.no_grad():
        heads = model(triples)
    return [f"Token {i + 1}: onset: {onset}, rhyme: {rhyme}, tone: {tone}"
            for i, (onset, rhyme, tone) in enumerate(argmax_parts(vocab, heads))]


def main(argv=None) -> list:
    """Prints and returns :func:`predict`'s lines."""
    args = parse_args(argv)
    vocab = None
    if args.vocab_file and os.path.isfile(args.vocab_file):
        with open(args.vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
    lines = predict(args.sentence, vocab, args.model_dim, args.device, args.seed)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
