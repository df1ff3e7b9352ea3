"""Answer-string metric suite: Accuracy, F1, BLEU, CIDEr, ROUGE-L.

A copy of ``phoneme_vqa_tpu/evaluation`` (pure Python and numpy):
``compute_scores(gts, gen)`` over ``{id: [str]}`` dicts returns
(corpus-level dict, per-sample dict). gens hold exactly one hypothesis per
id; gts may hold several references.
"""

from .accuracy import Accuracy
from .bleu import Bleu
from .cider import Cider
from .f1 import F1
from .rouge import Rouge


def compute_scores(gts, gen):
    metrics = (F1(), Accuracy(), Cider(), Rouge(), Bleu())
    all_score = {}
    all_scores = {}
    for metric in metrics:
        score, scores = metric.compute_score(gts, gen)
        all_score[str(metric)] = score
        all_scores[str(metric)] = scores
    return all_score, all_scores


__all__ = ["Accuracy", "Bleu", "Cider", "F1", "Rouge", "compute_scores"]
