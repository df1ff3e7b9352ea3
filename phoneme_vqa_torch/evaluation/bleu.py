"""Corpus BLEU-4 with 'closest' effective reference length and brevity
penalty (copy of ``phoneme_vqa_tpu/evaluation/bleu.py``; option
'closest').

Returns (corpus [bleu1..bleu4], per-sample [[bleu1..], ..4 lists]).
"""

from __future__ import annotations

import math
from collections import Counter

_SMALL = 1e-9
_TINY = 1e-15
_N = 4


def _ngram_counts(words, n_max=_N):
    counts = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts


def _closest_reflen(reflens, testlen):
    return min((abs(l - testlen), l) for l in reflens)[1]


class Bleu:
    def __init__(self, n: int = _N):
        self._n = n

    def compute_score(self, gts, res):
        assert gts.keys() == res.keys()
        n = self._n

        total = {"testlen": 0, "reflen": 0.0, "guess": [0] * n, "correct": [0] * n}
        per_sample = [[] for _ in range(n)]

        for key in res:
            hyp_words = res[key][0].split()
            testlen = len(hyp_words)
            hyp_counts = _ngram_counts(hyp_words, n)

            ref_maxcounts = Counter()
            reflens = []
            for ref in gts[key]:
                ref_words = ref.split()
                reflens.append(len(ref_words))
                for ngram, c in _ngram_counts(ref_words, n).items():
                    ref_maxcounts[ngram] = max(ref_maxcounts[ngram], c)

            reflen = _closest_reflen(reflens, testlen)
            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ngram, c in hyp_counts.items():
                correct[len(ngram) - 1] += min(ref_maxcounts[ngram], c)

            total["testlen"] += testlen
            total["reflen"] += reflen
            for k in range(n):
                total["guess"][k] += guess[k]
                total["correct"][k] += correct[k]

            # per-sample scores with per-sentence brevity penalty
            prod = 1.0
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
            for k in range(n):
                prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                per_sample[k].append(prod ** (1.0 / (k + 1)) * bp)

        corpus = []
        prod = 1.0
        ratio = (total["testlen"] + _TINY) / (total["reflen"] + _SMALL)
        bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
        for k in range(n):
            prod *= (total["correct"][k] + _TINY) / (total["guess"][k] + _SMALL)
            corpus.append(prod ** (1.0 / (k + 1)) * bp)

        return corpus, per_sample

    def __str__(self) -> str:
        return "BLEU"
