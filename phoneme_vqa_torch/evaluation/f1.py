"""Token-set F1 (copy of ``phoneme_vqa_tpu/evaluation/f1.py``)."""

import numpy as np


class F1:
    @staticmethod
    def _pair_f1(hyp_tokens, ref_tokens) -> float:
        if not hyp_tokens or not ref_tokens:
            # no-answer convention: 1 iff both sides agree exactly
            return float(hyp_tokens == ref_tokens)
        common = set(hyp_tokens) & set(ref_tokens)
        if not common:
            return 0.0
        precision = len(common) / len(hyp_tokens)
        recall = len(common) / len(ref_tokens)
        return 2 * precision * recall / (precision + recall)

    def compute_score(self, gts, res):
        per_sample = []
        for key, hyps in res.items():
            hyp = hyps[0].split()
            scores = [self._pair_f1(hyp, ref.split()) for ref in gts[key]]
            per_sample.append(float(np.mean(scores)))
        arr = np.asarray(per_sample)
        return arr.mean(), arr

    def __str__(self) -> str:
        return "F1"
