"""CIDEr (copy of ``phoneme_vqa_tpu/evaluation/cider.py``):
tf-idf n-gram cosine similarity (n=1..4) with clipping, a sigma=6 gaussian
length penalty, mean over n, mean over refs, x10. Document frequencies come
from the evaluation gts themselves (cider.py:29-39 passes no corpus).

Quirk kept: the 'length' used by the gaussian penalty counts *bigram*
occurrences (cider_scorer.py:110-111), not words.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

import numpy as np

_N = 4
_SIGMA = 6.0


def _ngram_counts(sentence: str, n_max=_N) -> Counter:
    words = sentence.split()
    counts = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts


class Cider:
    def __init__(self, gts=None, n: int = _N, sigma: float = _SIGMA):
        self._n = n
        self._sigma = sigma
        self.doc_frequency = None
        self.ref_len = None
        if gts is not None:
            self.doc_frequency, self.ref_len = self._df_from(gts)

    def _df_from(self, gts):
        df = defaultdict(float)
        for refs in gts.values():
            seen = set()
            for ref in refs:
                seen.update(_ngram_counts(ref, self._n).keys())
            for ngram in seen:
                df[ngram] += 1
        return df, np.log(float(len(gts)))

    def _tfidf_vec(self, counts, df, ref_len):
        vec = [defaultdict(float) for _ in range(self._n)]
        norm = [0.0] * self._n
        length = 0
        for ngram, tf in counts.items():
            idf = ref_len - np.log(max(1.0, df[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = tf * idf
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        penalty = math.e ** (-(delta**2) / (2 * self._sigma**2))
        vals = np.zeros(self._n)
        for k in range(self._n):
            acc = 0.0
            for ngram, h in vh[k].items():
                acc += min(h, vr[k][ngram]) * vr[k][ngram]
            if nh[k] != 0 and nr[k] != 0:
                acc /= nh[k] * nr[k]
            vals[k] = acc * penalty
        return vals

    def compute_score(self, gts, res):
        assert gts.keys() == res.keys()
        if self.doc_frequency is not None:
            df, ref_len = self.doc_frequency, self.ref_len
        else:
            df, ref_len = self._df_from(gts)

        scores = []
        for key in gts:
            hyp_vec, hyp_norm, hyp_len = self._tfidf_vec(
                _ngram_counts(res[key][0], self._n), df, ref_len
            )
            acc = np.zeros(self._n)
            refs = gts[key]
            for ref in refs:
                ref_vec, ref_norm, ref_len_i = self._tfidf_vec(
                    _ngram_counts(ref, self._n), df, ref_len
                )
                acc += self._sim(hyp_vec, ref_vec, hyp_norm, ref_norm, hyp_len, ref_len_i)
            scores.append(float(np.mean(acc)) / len(refs) * 10.0)

        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self) -> str:
        return "CIDEr"
