"""Exact-match accuracy (copy of ``phoneme_vqa_tpu/evaluation/accuracy.py``)."""

import numpy as np


class Accuracy:
    def compute_score(self, gts, res):
        per_sample = []
        for key, hyps in res.items():
            hyp = hyps[0]
            matches = [float(hyp == ref) for ref in gts[key]]
            per_sample.append(float(np.mean(matches)))
        arr = np.asarray(per_sample)
        return arr.mean(), arr

    def __str__(self) -> str:
        return "Accuracy"
