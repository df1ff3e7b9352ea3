"""Build the 3-part (onset / rhyme / tone) phoneme vocabulary from
annotation files (the port's counterpart of ``scripts/build_phoneme_vocab.py``).

    python -m phoneme_vqa_torch.build_phoneme_vocab --out phoneme_vocab.json \
        ann_train.json ann_dev.json [...]
"""

from __future__ import annotations

import argparse

from .phonology.vocab import VocabBuilder


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.build_phoneme_vocab")
    p.add_argument("annotations", nargs="+", help="annotation JSON files")
    p.add_argument("--out", default="phoneme_vocab.json")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Writes the vocabulary to ``--out``; returns each part's size."""
    args = parse_args(argv)
    builder = VocabBuilder(args.annotations)
    builder.save_vocab(args.out)
    sizes = {k: len(v) for k, v in builder.vocab.items()}
    print(f"Saved {args.out}: {sizes}")
    return sizes


if __name__ == "__main__":
    main()
