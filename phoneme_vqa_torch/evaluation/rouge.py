"""ROUGE-L (copy of ``phoneme_vqa_tpu/evaluation/rouge.py``):
LCS-based F-measure with beta=1.2, max precision/recall over references.
"""

from __future__ import annotations

import numpy as np

_BETA = 1.2


def _lcs_len(a, b) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


class Rouge:
    def calc_score(self, candidate, refs) -> float:
        hyp = candidate[0].split(" ")
        precs, recs = [], []
        for ref in refs:
            ref_tokens = ref.split(" ")
            lcs = _lcs_len(ref_tokens, hyp)
            precs.append(lcs / float(len(hyp)))
            recs.append(lcs / float(len(ref_tokens)))
        p, r = max(precs), max(recs)
        if p != 0 and r != 0:
            return ((1 + _BETA**2) * p * r) / float(r + _BETA**2 * p)
        return 0.0

    def compute_score(self, gts, res):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[key], gts[key]) for key in gts]
        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self) -> str:
        return "ROUGE"
