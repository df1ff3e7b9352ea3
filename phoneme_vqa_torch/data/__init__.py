from .adapters import textlayout_obj_adapt, textlayout_ocr_adapt
from .latr import LaTrDataset
from .loader import ArrayDataset, batch_iterator, num_batches
from .prestu import PreSTUDataset, fuse_question_ocr
from .sal import SaLDataset

__all__ = [
    "ArrayDataset", "LaTrDataset", "PreSTUDataset", "SaLDataset", "batch_iterator",
    "fuse_question_ocr", "num_batches",
    "textlayout_obj_adapt", "textlayout_ocr_adapt",
]
